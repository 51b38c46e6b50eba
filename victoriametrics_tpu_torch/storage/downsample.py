"""Background downsampling & per-resolution retention tiers.

Modeled on the reference's historicalMergeWatcher final-dedup pass
(lib/storage/table.go:474) and the -downsampling.period flag family: aged
raw data is re-rolled into coarser-resolution parts, one aggregated sample
per bucket, keeping FIVE aggregate columns (last/min/max/count/sum) so
avg/min/max/count/rate/increase rollups stay answerable without the raw
stream.

Grammar (``VM_DOWNSAMPLE``): ``offset:resolution[:retention],...`` — e.g.
``30d:5m,180d:1h`` keeps data older than 30 days at 5-minute resolution
and data older than 180 days at 1-hour resolution. Offsets and resolutions
must be strictly increasing. A tier's retention defaults to the NEXT
tier's offset (its samples become redundant once the coarser tier covers
that age); the last tier keeps its data forever unless an explicit third
field bounds it. Raw retention (``Storage.retention_ms``) is unchanged.

Bucketing REUSES the query-time dedup window (dedup._buckets): windows are
right-inclusive at exact interval multiples, and the ``last`` column is
literally ``dedup.deduplicate`` at the tier resolution (highest timestamp
wins; timestamp ties prefer the max non-stale value), so query-time dedup
and downsampling can never disagree on a boundary. min/max/count/sum
aggregate the NON-stale samples of each bucket (the eval drops staleness
markers before those rollups, so the coarse columns must too); a bucket
whose samples are all staleness markers appears only in the ``last``
column, carrying the marker so ``default_rollup`` still terminates the
series.

On-disk layout, inside each monthly partition dir::

    <partition>/ds_<resolution_ms>/
        tier.json                  # manifest: resolution, coverage, parts
        p_<seq>_last/ ... p_<seq>_sum/   # ordinary Parts (PR-10 format)

tier.json carries a meta_crc like every other manifest; parts carry the
full per-file crc32 set.  The rewrite publishes part dirs first (each via
the PartWriter tmp+rename_durable seam), fires the
``downsample:post_rename_pre_manifest`` crashpoint, then commits tier.json
— a crash between the two leaves unlisted part dirs that the next open
sweeps, identical to the merge discipline.  A torn tier (bad tier.json or
a bad listed part) is quarantined WHOLE and the tier resets to empty
coverage: the next pass rebuilds it from whatever raw survives, and the
quarantine is reported loudly like any PR-10 quarantine.

The port's copy of ``victoriametrics_tpu/storage/downsample.py``, whole.
"""

from __future__ import annotations

import os
import re
import shutil

import numpy as np

from ..utils import fs as fslib
from ..utils import logger
from ..utils import metrics as metricslib
from ..ops import decimal as dec
from .block import Block, rows_to_blocks
from .dedup import _buckets, deduplicate
from .part import Part, PartWriter

#: tier dir name prefix inside a partition dir: ds_<resolution_ms>
TIER_DIR_PREFIX = "ds_"
#: aggregate columns kept per bucket (part name suffix = column)
AGG_COLUMNS = ("last", "min", "max", "count", "sum")

_PASSES = metricslib.REGISTRY.counter("vm_downsample_passes_total")
_ROWS_IN = metricslib.REGISTRY.counter("vm_downsample_rows_in_total")
_ROWS_OUT = metricslib.REGISTRY.counter("vm_downsample_rows_out_total")
_PARTS = metricslib.REGISTRY.counter("vm_downsample_parts_total")
_DURATION = metricslib.REGISTRY.float_counter(
    "vm_downsample_duration_seconds_total")
_TIERS_QUARANTINED = metricslib.REGISTRY.counter(
    'vm_parts_quarantined_total{store="downsample"}')

_DUR_RE = re.compile(r"^(\d+)(ms|s|m|h|d|w|y)$")
_DUR_UNITS = {"ms": 1, "s": 1000, "m": 60_000, "h": 3_600_000,
              "d": 86_400_000, "w": 7 * 86_400_000, "y": 365 * 86_400_000}


def parse_duration_ms(s: str) -> int:
    """``30d`` / ``5m`` / ``90s`` -> milliseconds (single unit, like the
    reference's -downsampling.period fields)."""
    m = _DUR_RE.match(s.strip())
    if m is None:
        raise ValueError(f"bad duration {s!r} (want <int><ms|s|m|h|d|w|y>)")
    return int(m.group(1)) * _DUR_UNITS[m.group(2)]


class Tier:
    """One downsampling tier: data older than ``offset_ms`` is kept at
    ``resolution_ms``; its parts are dropped once older than
    ``retention_ms`` (0 = kept forever)."""

    __slots__ = ("offset_ms", "resolution_ms", "retention_ms")

    def __init__(self, offset_ms: int, resolution_ms: int,
                 retention_ms: int = 0):
        self.offset_ms = offset_ms
        self.resolution_ms = resolution_ms
        self.retention_ms = retention_ms

    def __repr__(self):
        return (f"Tier(offset={self.offset_ms}ms, "
                f"res={self.resolution_ms}ms, keep={self.retention_ms}ms)")


def parse_spec(spec: str) -> list[Tier]:
    """``VM_DOWNSAMPLE`` grammar -> ordered tier list (finest first).

    ``offset:resolution[:retention]`` per tier, comma-separated; offsets
    and resolutions must be strictly increasing (the reference rejects
    non-monotonic -downsampling.period sets the same way), and each
    coarser resolution must be an integer MULTIPLE of the next finer
    one: the read path cascades coarse-tier -> fine-tier -> raw at the
    coarse tier's bucket-aligned watermark, which splits the finer
    tier's buckets cleanly only when the resolutions nest."""
    spec = (spec or "").strip()
    if not spec:
        return []
    tiers = []
    for item in spec.split(","):
        fields = item.strip().split(":")
        if len(fields) not in (2, 3):
            raise ValueError(
                f"bad VM_DOWNSAMPLE item {item!r} "
                f"(want offset:resolution[:retention])")
        off = parse_duration_ms(fields[0])
        res = parse_duration_ms(fields[1])
        keep = parse_duration_ms(fields[2]) if len(fields) == 3 else -1
        if res <= 0 or off <= 0:
            raise ValueError(f"bad VM_DOWNSAMPLE item {item!r}: "
                             f"offset/resolution must be positive")
        if keep >= 0 and keep <= off:
            raise ValueError(f"bad VM_DOWNSAMPLE item {item!r}: "
                             f"retention must exceed the offset")
        tiers.append((off, res, keep))
    tiers.sort()
    out = []
    for i, (off, res, keep) in enumerate(tiers):
        if i and res <= out[-1].resolution_ms:
            raise ValueError(
                "VM_DOWNSAMPLE resolutions must increase with offsets")
        if i and res % out[-1].resolution_ms:
            raise ValueError(
                "VM_DOWNSAMPLE resolutions must nest: each coarser "
                "resolution must be a multiple of the next finer one")
        if keep < 0:
            # default: redundant once the NEXT tier covers this age
            keep = tiers[i + 1][0] if i + 1 < len(tiers) else 0
        out.append(Tier(off, res, keep))
    return out


def note_pass(duration_s: float) -> None:
    """Account one completed per-partition/per-tier rewrite pass."""
    _PASSES.inc()
    _DURATION.inc(duration_s)


def read_enabled() -> bool:
    """``VM_DOWNSAMPLE_READ=0`` disables tier SELECTION at query time (the
    raw oracle escape hatch); the background rewrite keeps running.
    Re-read per call so tests and bench A/B legs can flip it live."""
    return os.environ.get("VM_DOWNSAMPLE_READ", "1") != "0"


def count_tail_piece(piece, as_float: bool):
    """Raw rows serving a COUNT-hinted fetch: each non-stale sample
    contributes 1 (its VALUE is not a count), so summing the mixed
    tier-count-column + raw-tail stream yields the true sample count.
    Staleness markers survive untouched — the eval-side stale drop must
    still see them.  Applied to every raw/mem piece of a count fetch
    (even when no tier ends up serving: a sum of ones IS the count, so
    the eval-level count->sum rewrite stays unconditional)."""
    if as_float:
        mids, cnts, ts_c, vals = piece
        return (mids, cnts, ts_c,
                np.where(dec.is_stale_nan(vals), vals, 1.0))
    mids, cnts, scales, ts_c, mant = piece
    mant = np.where(mant == dec.V_STALE_NAN, mant,
                    np.int64(1)).astype(np.int64)
    return (mids, cnts, np.zeros_like(scales), ts_c, mant)


# -- per-bucket aggregation ------------------------------------------------

def aggregate_series(ts: np.ndarray, vals: np.ndarray, res_ms: int):
    """One series' sorted raw rows -> per-bucket aggregate columns.

    Returns ``{agg: (out_ts, out_vals)}`` for the five AGG_COLUMNS.
    Output samples are stamped at the bucket's right edge (``bucket*res``)
    — the only timestamp guaranteed inside every right-inclusive rollup
    window that fully covers the bucket.

    ``last`` is exactly ``dedup.deduplicate(ts, vals, res_ms)`` restamped,
    so the query-time dedup path and the downsample path share one
    boundary/tie/stale-marker semantics by construction (the golden test
    pins this).  min/max/count/sum cover non-stale samples only."""
    keep_ts, keep_vals = deduplicate(ts, vals, res_ms)
    last_ts = _buckets(keep_ts, res_ms) * res_ms
    out = {"last": (last_ts, np.asarray(keep_vals, np.float64))}
    ns = ~dec.is_stale_nan(vals)
    if not ns.all():
        ts, vals = ts[ns], vals[ns]
    if ts.size == 0:
        empty = (np.zeros(0, np.int64), np.zeros(0, np.float64))
        for agg in ("min", "max", "count", "sum"):
            out[agg] = empty
        return out
    b = _buckets(ts, res_ms)
    starts = np.flatnonzero(np.r_[True, b[1:] != b[:-1]])
    ends = np.r_[starts[1:], ts.size]
    out_ts = b[starts] * res_ms
    vals = np.asarray(vals, np.float64)
    out["min"] = (out_ts, np.minimum.reduceat(vals, starts))
    out["max"] = (out_ts, np.maximum.reduceat(vals, starts))
    out["count"] = (out_ts, (ends - starts).astype(np.float64))
    # sequential per-bucket sums (np.add.reduceat): the batched rollup's
    # cumsum formulation matches this bit-exactly only for values without
    # accumulated rounding (the oracle tests use integer-representable
    # values; general floats agree to ~ulp — documented tolerance)
    out["sum"] = (out_ts, np.add.reduceat(vals, starts))
    return out


# -- one tier inside one partition -----------------------------------------

class PartitionTier:
    """Open state of ``<partition>/ds_<res>/``: manifest + Parts.

    NOT thread-safe on its own — the owning Partition serializes mutation
    under its flush mutex and snapshots ``parts_for`` under its data lock
    (same discipline as the raw part list)."""

    def __init__(self, path: str, resolution_ms: int):
        self.path = path
        self.resolution_ms = resolution_ms
        #: highest raw timestamp consumed into this tier (bucket-aligned
        #: right edge); rewrites resume strictly after it
        self.covered_max_ts = -(1 << 62)
        self._seq = 0
        #: agg column -> open Parts (time-ordered by construction)
        self._parts: dict[str, list[Part]] = {a: [] for a in AGG_COLUMNS}
        self._names: list[str] = []

    # -- lifecycle ---------------------------------------------------------

    def _manifest(self) -> str:
        return os.path.join(self.path, "tier.json")

    @classmethod
    def open(cls, path: str, resolution_ms: int, quarantined: list,
             partition_name: str) -> "PartitionTier":
        """Open an existing tier dir; integrity failures quarantine the
        WHOLE tier (coverage resets, the pass rebuilds from raw)."""
        self = cls(path, resolution_ms)
        listed: list[str] = []
        try:
            if os.path.exists(self._manifest()):
                meta = fslib.load_meta_json(self._manifest())
                if int(meta["resolutionMs"]) != resolution_ms:
                    raise fslib.IntegrityError(
                        f"tier dir {path} says resolutionMs="
                        f"{meta['resolutionMs']}")
                self.covered_max_ts = int(meta["coveredMaxTs"])
                listed = list(meta["parts"])
                for name in listed:
                    p = Part(os.path.join(path, name))
                    self._register_open_part(name, p)
        except (fslib.IntegrityError, ValueError, KeyError, OSError) as e:
            # torn tier: move the whole dir aside (PR-10 discipline) and
            # reset — downsampled data is derived, so the quarantine is
            # self-healing as long as raw survives, but it is REPORTED
            # like any other quarantine (results flagged partial)
            parent = os.path.dirname(path)
            name = os.path.basename(path)
            try:
                quarantined.append(fslib.quarantine_dir_entry(
                    parent, name, e, "downsample", partition_name))
                _TIERS_QUARANTINED.inc()
            except OSError as move_err:
                logger.errorf("downsample: cannot quarantine tier %s: %s",
                              path, move_err)
                shutil.rmtree(path, ignore_errors=True)
            return cls(path, resolution_ms)
        # sweep crash leftovers: part dirs (or .tmp dirs) not in tier.json
        for name in os.listdir(path):
            full = os.path.join(path, name)
            if name == "tier.json" or not os.path.isdir(full):
                continue
            if name not in listed:
                shutil.rmtree(full, ignore_errors=True)
        return self

    def _register_open_part(self, name: str, p: Part) -> None:
        agg = name.rsplit("_", 1)[-1]
        if agg not in AGG_COLUMNS:
            raise ValueError(f"tier part {name!r} has no aggregate suffix")
        self._parts[agg].append(p)
        self._names.append(name)
        seq = int(name.split("_")[1])
        self._seq = max(self._seq, seq + 1)

    def close(self) -> None:
        for parts in self._parts.values():
            for p in parts:
                p.close()
            parts.clear()
        self._names = []

    # -- reads -------------------------------------------------------------

    @property
    def has_parts(self) -> bool:
        return bool(self._names)

    def parts_for(self, agg: str) -> list[Part]:
        return list(self._parts[agg])

    @property
    def rows(self) -> int:
        return sum(p.rows for parts in self._parts.values() for p in parts)

    # -- rewrite -----------------------------------------------------------

    def next_part_name(self) -> str:
        name = f"p_{self._seq:016d}"
        self._seq += 1
        return name

    def write_manifest(self) -> None:
        """Durably (re)commit tier.json via the standard tmp+rename seam.
        Callers fire ``downsample:post_rename_pre_manifest`` BETWEEN part
        publication and this commit."""
        os.makedirs(self.path, exist_ok=True)
        tmp = self._manifest() + ".tmp"
        fslib.write_meta_json(
            tmp,
            {"resolutionMs": self.resolution_ms,
             "coveredMaxTs": self.covered_max_ts,
             "parts": list(self._names)})
        fslib.rename_durable(tmp, self._manifest())

    def publish_parts(self, names: list[str], parts: dict[str, Part],
                      covered_max_ts: int) -> None:
        """Register freshly renamed part dirs + advance coverage (the
        manifest commit itself is the caller's write_manifest call)."""
        for name in names:
            self._register_open_part(name, parts[name.rsplit("_", 1)[-1]])
        self.covered_max_ts = covered_max_ts
        # keep _seq monotonic even when publish order races reopen
        self._seq = max(self._seq,
                        max(int(n.split("_")[1]) for n in names) + 1)


def rewrite_range(tier_state: PartitionTier, merged_blocks, hi: int,
                  resolution_ms: int) -> tuple[int, int, dict[str, Part],
                                               list[str]]:
    """Aggregate a (tsid, ts)-ordered merged block stream into one new
    part per aggregate column.

    ``merged_blocks`` yields Blocks already tombstone-filtered, deduped
    and left-clipped (``_merge_block_streams`` output); rows above ``hi``
    (the bucket-aligned age cutoff) are clipped here so a later pass
    re-reads them once their buckets complete.

    Returns ``(rows_in, rows_out, {agg: Part}, part_names)`` — parts are
    renamed into place (durable) but NOT yet listed in tier.json; the
    caller fires the crash seam and commits the manifest.  Returns
    ``(0, 0, {}, [])`` when the range holds no rows."""
    base = tier_state.next_part_name()
    writers = {agg: PartWriter(os.path.join(tier_state.path,
                                            f"{base}_{agg}"),
                               resolution_ms=resolution_ms)
               for agg in AGG_COLUMNS}
    bufs: dict[str, list[Block]] = {agg: [] for agg in AGG_COLUMNS}
    rows_in = rows_out = 0

    def emit(tsid, ts_cat, val_cat):
        nonlocal rows_in, rows_out
        rows_in += int(ts_cat.size)
        for agg, (ots, ovals) in aggregate_series(
                ts_cat, val_cat, resolution_ms).items():
            if ots.size == 0:
                continue
            # clamp the final bucket's stamp into the rewritten range:
            # at a partition seam `hi` is the partition's last inclusive
            # ms, NOT bucket-aligned, and the right-inclusive bucket
            # ending at the next midnight belongs to the NEXT partition
            # too — an unclamped stamp would collide with that
            # partition's first bucket and assembly would drop one of
            # the duplicate-ts rows (under-counting the seam window).
            # Ordering survives: only the last bucket can exceed `hi`.
            np.minimum(ots, hi, out=ots)
            if agg == "last":
                rows_out += int(ots.size)
            for blk in rows_to_blocks(tsid, ots, ovals):
                bufs[agg].append(blk)
            if len(bufs[agg]) >= 1024:
                writers[agg].write_blocks_bulk(bufs[agg])
                bufs[agg] = []

    try:
        cur_tsid = None
        ts_acc: list[np.ndarray] = []
        val_acc: list[np.ndarray] = []
        for b in merged_blocks:
            ts = b.timestamps
            if int(ts[0]) > hi:
                continue
            vals = b.float_values()
            if int(ts[-1]) > hi:
                n = int(np.searchsorted(ts, hi, side="right"))
                ts, vals = ts[:n], vals[:n]
            if cur_tsid is not None and \
                    b.tsid.metric_id != cur_tsid.metric_id:
                emit(cur_tsid, np.concatenate(ts_acc),
                     np.concatenate(val_acc))
                ts_acc, val_acc = [], []
            cur_tsid = b.tsid
            ts_acc.append(ts)
            val_acc.append(vals)
        if cur_tsid is not None and ts_acc:
            emit(cur_tsid, np.concatenate(ts_acc), np.concatenate(val_acc))
        if rows_out == 0:
            for w in writers.values():
                w.abort()
            return 0, 0, {}, []
        parts: dict[str, Part] = {}
        names: list[str] = []
        for agg in AGG_COLUMNS:
            if bufs[agg]:
                writers[agg].write_blocks_bulk(bufs[agg])
            if writers[agg].rows == 0:
                # possible only when every bucket in range was all-stale
                # for this column; publish no dir for it
                writers[agg].abort()
                continue
            writers[agg].close()
            parts[agg] = Part(writers[agg].path, trusted=True)
            names.append(f"{base}_{agg}")
    except BaseException:
        for w in writers.values():
            w.abort()
        raise
    _ROWS_IN.inc(rows_in)
    _ROWS_OUT.inc(rows_out)
    _PARTS.inc(len(names))
    return rows_in, rows_out, parts, names
