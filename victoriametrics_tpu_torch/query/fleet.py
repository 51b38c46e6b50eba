"""Fleet-batched device serving: every resident stream of one bucket shape
served by ONE launch per interval.

Port of ``victoriametrics_tpu/query/fleet.py``.  A dashboard
holds many standing queries (streams), each of which would otherwise pay
its own rollup launch every interval.  This plane stacks the rolling
windows of all device-resident streams of one bucket shape on a leading
stream axis ([B, S, N] planes), lands every stream's new samples with one
B10 ``fleet_append_tile`` per bucket, and computes every due stream's
[G, T] aggregate with one B9 ``fleet_rollup_aggregate_tile`` per bucket;
B11 ``fleet_compact_tile`` slides a member's window when its columns run
out.

Lifecycle of a stream through the fleet:

1. **adoption**: a cold query left the stream's rolling window resident
   (``cuda_engine.register_window`` filed it under the stream's roll-state
   key).  The next interval's run pulls a host copy of that window, CROPS
   it to the stream's fetch bound and rebases it there, drops the
   per-shape entry, and packs the copy into a slot of a bucket.
2. **bucketing**: a bucket is a shape class (func, step, lookback, S_b,
   N_b, T_b, G_b), every dimension rounded up the ladder
   {1, 1.5} * 2^k (floor ``VM_FLEET_LADDER_MIN``), so series churn and
   grid drift land in an existing shape.  Padded rows carry counts 0 and
   TS_PAD, padded steps are sliced off on the host, padded groups
   aggregate to NaN and are dropped.
3. **interval run**: every due member advances (a slice fetch under
   ``advance_rolling``'s guards; a violated guard EVICTS the member, whose
   own evaluation then rebuilds a per-stream window, re-adoptable later),
   staged suffixes land in one append per bucket, and one launch per
   bucket computes all due members' aggregates.  The [B, G, T] result
   comes back once and is sliced per stream into a result table.
4. **serving**: an evaluation asks :func:`take` first; a grid- and
   version-matched result answers with no storage read and no launch.
   The launch's cost is split per stream by rows share (the last due
   member takes the remainder, so the shares sum exactly to the launch).

Each bucket keeps an authoritative HOST mirror (numpy) beside its device
planes: appends and compactions apply to both, so a membership change
re-uploads from the mirror instead of pulling [B, S, N] back.  Uploads are
private copies (``tile_cache.chunked_device_put``), since B10 writes the
device planes in place.

On an engine with a mesh the plane shards the stream axis over the mesh's
devices (``parallel.mesh.make_fleet_mesh``): a bucket's slots round up to
a multiple of the stream axis, its planes are uploaded per the partition
rules as per-shard slices of streams, B10 and B11 run per shard, and B14
(``cached_fleet_rollup_aggregate``) runs B9 on each shard's streams into
one [B, G, T] output for the single host pull.

The plane reads a stream's shape from its query text (``st.q``), parsed
and analysed as the evaluator does (``exec.parse_cached``,
``eval._device_aggr_shape``), with the limits of the serving front end's
evaluation context (``api._ec``, whose ``EvalConfig`` carries the
engine as ``tpu``, as the reference's ``PrometheusAPI._ec`` does).  A
served stream's share of the shared launch goes into the query's cost
tracker (``device:execute``, ``device:upload``), and adoption, eviction,
packing and the launch are flight-recorder events, as in the reference.
The streams come from the serving front end's registry
(``api.matstreams``, the port's ``query/matstream.MatStreamRegistry``:
``streams()`` and each stream's ``due(now_ms)``), whose every advance calls
``prepass`` before it evaluates.  Buckets are float64, the port's only tile type, so the rebase-offset
plane v0 is zeros; a quantile's window (``qx`` set in its roll-state
entry) is never adopted, as in the reference.

``VM_DEVICE_FLEET=0`` disables the plane: the per-stream rolling path
(``advance_rolling`` + ``run_fused_on_tiles``) then serves every stream,
the escape hatch and the equality oracle.
"""

from __future__ import annotations

import os
import sys
import threading
import time

import numpy as np

from ..models import tile_cache
from ..ops.device_rollup import (FLEET_AGGR_CODES, TS_PAD,
                                 fleet_append_tile, fleet_compact_tile,
                                 fleet_layout, fleet_rollup_aggregate_tile,
                                 normalized_cfg)
from ..ops.rollup_np import CORE_SUPPORTED, RollupConfig
from ..parallel import mesh as meshlib
from ..parallel.partition import (AXIS_STREAM, axis_multiple, host_rows,
                                  per_shard, shard_put)
from ..utils import costacc, flightrec
from ..utils import metrics as metricslib
from .cuda_engine import (RollingTile, _pull_host, device_roll_keys,
                          tile_capacity, tile_shape, timed_kernel_call)
from .eval import _device_aggr_shape, filters_from_metric_expr
from .exec import parse_cached
from .metricsql.ast import AggrFuncExpr

_LAUNCHES = metricslib.REGISTRY.counter("vm_device_fleet_launches_total")
#: incremented by the number of due streams each launch served: the ratio
#: to _LAUNCHES is the amortization factor
_STREAMS = metricslib.REGISTRY.counter(
    "vm_device_fleet_streams_per_launch_total")
_ADOPTIONS = metricslib.REGISTRY.counter("vm_device_fleet_adoptions_total")
_EVICTIONS = metricslib.REGISTRY.counter("vm_device_fleet_evictions_total")
_SERVED = metricslib.REGISTRY.counter("vm_device_fleet_served_total")


def enabled() -> bool:
    """Fleet batching on?  VM_DEVICE_FLEET=0 falls back to the per-stream
    rolling path: the escape hatch and equality oracle."""
    return os.environ.get("VM_DEVICE_FLEET", "1") != "0"


def ladder_min() -> int:
    try:
        return max(int(os.environ.get("VM_FLEET_LADDER_MIN", "8")), 1)
    except ValueError:
        return 8


def max_members() -> int:
    try:
        return max(int(os.environ.get("VM_FLEET_MAX", "256")), 1)
    except ValueError:
        return 256


def bucket_up(n: int, minimum: int | None = None) -> int:
    """Smallest ladder value >= n from the geometric ladder {1, 1.5} * 2^k
    scaled from `minimum` (default VM_FLEET_LADDER_MIN): m, 1.5m, 2m, 3m,
    4m, 6m, ... — at most 50% padding, and churn within a rung keeps the
    bucket's shape.  Rungs are computed directly (m<<k / 3m<<k>>1), not by
    cumulative floored multiplies, which stall forever at 1."""
    m = max(minimum if minimum is not None else ladder_min(), 1)
    b, j = m, 0
    while b < n:
        j += 1
        b = m << (j // 2) if j % 2 == 0 else (3 * m << (j // 2)) >> 1
    return b


class FleetMember:
    """One adopted stream: identity, grid parameters and host-side series
    bookkeeping.  Its samples live in the bucket's planes at ``slot``."""

    __slots__ = (
        "skey", "stream_key", "me", "tenant", "max_series",
        "func", "aggr", "step", "duration", "window", "lookback",
        "lookback_delta", "offset", "drop_stale",
        "S", "G", "T", "group_keys", "gids",
        "base_ms", "lo_ms", "hi_ms", "version", "structural",
        "counts", "row_of_raw", "segments", "bucket", "slot",
    )

    def samples_in_range(self, fetch_lo: int) -> int:
        return sum(n for _, seg_hi, n in self.segments if seg_hi >= fetch_lo)


class FleetBucket:
    """One shape class: members' planes stacked on a leading stream axis,
    device tensors plus authoritative host mirrors."""

    __slots__ = ("key", "func", "step", "lookback",
                 "B_pad", "S_b", "N_b", "T_b", "G_b", "cfg",
                 "members", "ts_h", "vals_h", "counts_h", "gids_h",
                 "v0_h", "aggr_h", "dev", "dirty",
                 "last_up_bytes", "last_up_wall")

    def __init__(self, key, n_stream: int = 1):
        (self.func, self.step, self.lookback,
         self.S_b, self.N_b, self.T_b, self.G_b) = key
        self.key = key
        self.B_pad = 0
        self.members: list[FleetMember] = []
        self.dev = None
        self.dirty = True
        self.last_up_bytes = 0
        self.last_up_wall = 0.0
        self.cfg = normalized_cfg(self.func, RollupConfig(
            start=0, end=(self.T_b - 1) * self.step, step=self.step,
            window=self.lookback))
        self._alloc(n_stream)

    def _alloc(self, n_stream: int, b_need: int = 1) -> None:
        """(Re)allocate mirrors for at least `b_need` stream slots
        (ladder-bucketed, rounded up to the mesh's stream-axis size)."""
        b = bucket_up(max(b_need, 1))
        b = -(-b // n_stream) * n_stream
        if b <= self.B_pad:
            return
        old = self.B_pad
        ts = np.full((b, self.S_b, self.N_b), TS_PAD, dtype=np.int32)
        vals = np.zeros((b, self.S_b, self.N_b), dtype=np.float64)
        counts = np.zeros((b, self.S_b), dtype=np.int32)
        gids = np.zeros((b, self.S_b), dtype=np.int32)
        v0 = np.zeros((b, self.S_b), dtype=np.float64)
        aggr = np.zeros(b, dtype=np.int32)
        if old:
            ts[:old] = self.ts_h
            vals[:old] = self.vals_h
            counts[:old] = self.counts_h
            gids[:old] = self.gids_h
            v0[:old] = self.v0_h
            aggr[:old] = self.aggr_h
        self.ts_h, self.vals_h, self.counts_h = ts, vals, counts
        self.gids_h, self.v0_h, self.aggr_h = gids, v0, aggr
        self.B_pad = b
        self.dirty = True


class FleetResult:
    """One served interval of one member, consumed by :func:`take`.  Cost
    shares are consumed ONCE (zeroed on the first take), so repeated
    evaluations in an interval never charge the launch twice."""

    __slots__ = ("start", "end", "step", "version", "structural",
                 "lookback_delta", "rows", "group_keys", "samples",
                 "exec_share_s", "up_share_s", "up_share_b")


class FleetPlane:
    """Per-engine fleet state.  One coarse lock: the run (adoption,
    advance, append, launch) and take() serialize on it; it never takes a
    stream's or registry's lock, and the window-cache and storage locks it
    reaches never call back."""

    def __init__(self, engine):
        self.engine = engine
        self._lock = threading.Lock()
        self._members: dict = {}      # skey -> FleetMember
        self._buckets: dict = {}      # bucket key -> FleetBucket
        self._results: dict = {}      # skey -> FleetResult
        self._memo: dict = {}         # stream key -> shape info | False
        # skey -> remaining full-evaluation retries after an eviction: the
        # fleet re-adopts only from a per-shape window, which the serving
        # layer rebuilds only when resident() says so
        self._rebuild_retry: dict = {}
        self.launches = 0
        self.served = 0
        self.adoptions = 0
        self.evictions = 0
        self.adopt_s = 0.0     # wall seconds spent adopting (pull + crop)
        self.last_decline = ""
        # the stream-axis mesh over the engine mesh's devices, or None
        self._mesh = None
        if getattr(engine, "mesh", None) is not None:
            self._mesh = meshlib.make_fleet_mesh(
                list(engine.mesh.devices.flat))

    def n_stream(self) -> int:
        return axis_multiple(self._mesh, AXIS_STREAM)

    def has(self, skey) -> bool:
        with self._lock:
            return skey in self._members

    def wants_rebuild(self, skey) -> bool:
        """Consume one post-eviction retry: True routes this refresh
        through the full device evaluation so the per-shape window (and
        with it the adoption path) can come back."""
        with self._lock:
            n = self._rebuild_retry.get(skey)
            if n is None:
                return False
            if n <= 1:
                self._rebuild_retry.pop(skey, None)
            else:
                self._rebuild_retry[skey] = n - 1
            return True

    def stats(self) -> dict:
        with self._lock:
            return {"members": len(self._members),
                    "buckets": len(self._buckets),
                    "launches": self.launches, "served": self.served,
                    "adoptions": self.adoptions,
                    "evictions": self.evictions}

    # -- stream-shape analysis (memoized per stream identity) -------------

    def _analyze(self, api, st):
        key = (st.tenant, st.q, st.step, st.duration)
        info = self._memo.get(key)
        if info is not None:
            return info or None
        info = self._analyze_uncached(api, st)
        self._memo[key] = info if info is not None else False
        return info

    def _analyze_uncached(self, api, st):
        e = parse_cached(st.q)
        if not isinstance(e, AggrFuncExpr):
            return None
        shape = _device_aggr_shape(e)
        if shape is None:
            return None
        phi, func, rarg = shape
        # quantile's dense [G, M, T] doesn't batch; per-stream residency
        # still serves it
        if phi is not None or e.name not in FLEET_AGGR_CODES or \
                func not in CORE_SUPPORTED:
            return None
        window = rarg.window.value_ms(st.step) if rarg.window is not None \
            else 0
        offset = rarg.offset.value_ms(st.step) if rarg.offset is not None \
            else 0
        ec = api._ec(0, st.duration, st.step, st.tenant)
        skey, _ = device_roll_keys(str(rarg.expr), ec.tenant, func, e.name,
                                   phi, e.grouping, e.without, ec.max_series,
                                   window)
        if skey is None:
            return None
        lookback = window if window > 0 else (
            ec.lookback_delta if func == "default_rollup" else st.step)
        return {"skey": skey, "func": func, "aggr": e.name,
                "aggr_code": FLEET_AGGR_CODES[e.name], "window": window,
                "offset": offset, "lookback": lookback,
                "lookback_delta": ec.lookback_delta,
                "drop_stale": func not in ("default_rollup",
                                           "stale_samples_over_time"),
                "me": rarg.expr, "max_series": ec.max_series}

    # -- the per-interval batch scheduler ---------------------------------

    def run(self, api, now_ms: int) -> int:
        """Advance and launch every due member; adopt newly resident
        streams.  Returns the number of fused launches."""
        with self._lock:
            return self._run_locked(api, now_ms)

    def _run_locked(self, api, now_ms: int) -> int:
        reg = getattr(api, "matstreams", None)
        if reg is None:
            return 0
        ver = getattr(api.storage, "data_version", None)
        if ver is None or \
                getattr(api.storage, "structural_version", None) is None:
            return 0
        work: list[tuple[FleetMember, int]] = []   # (member, query end)
        for st in reg.streams():
            if not st.due(now_ms):
                continue
            info = self._analyze(api, st)
            if info is None:
                continue
            end_q = (now_ms // st.step) * st.step
            m = self._members.get(info["skey"])
            if m is None:
                m = self._adopt(api, st, info, end_q)
                if m is None:
                    continue
            r = self._results.get(m.skey)
            if r is not None and r.end == end_q - m.offset and \
                    r.version == ver:
                continue  # this interval already served by a prior run
            work.append((m, end_q))
        if not work:
            return 0
        staged: dict = {}   # bucket -> list[(member, cols, rows_idx)]
        due: dict = {}      # bucket -> list[(member, end_q)]
        for m, end_q in work:
            verdict = self._advance_member(api, m, end_q)
            if verdict == "evict":
                self._evict(m, self.last_decline)
                continue
            if verdict == "skip":
                continue
            if isinstance(verdict, tuple):
                staged.setdefault(m.bucket, []).append((m,) + verdict)
            due.setdefault(m.bucket, []).append((m, end_q))
        touched = set(staged) | {b for b in self._buckets.values()
                                 if b.dirty and b.members}
        t_pack = time.perf_counter()
        for b in touched:
            self._stage_to_mirror(b, staged.get(b, ()))
            if b.dirty:
                self._upload(b)
            else:
                self._append_device(b, staged.get(b, ()))
        flightrec.rec("device:fleet_pack", t_pack,
                      time.perf_counter() - t_pack,
                      arg=f"{len(work)} streams, {len(touched)} buckets")
        n = 0
        for b, mems in due.items():
            if b.members and b.dev is not None:
                self._launch(api, b, mems)
                n += 1
        return n

    # -- adoption ---------------------------------------------------------

    def _adopt(self, api, st, info, end_q):
        t_adopt = time.perf_counter()
        wcache = self.engine.window_cache()
        stv = wcache.peek(info["skey"])
        if stv is None:
            return None  # not yet device-resident; the stream's own
            #              evaluation builds the per-stream window first
        rt, groups, group_keys, qx, _rb = stv
        if qx is not None or not isinstance(rt, RollingTile):
            return None
        storage = api.storage
        # the member inherits the tile's version watermark; the advance
        # right after adoption runs advance_rolling's late-data and delete
        # guards, so version drift since the tile was built is no blocker
        # — structural drift is (the tile's series set may be stale)
        if getattr(storage, "data_version", None) is None or \
                getattr(storage, "structural_version", None) != \
                rt.structural or getattr(storage, "dedup_interval_ms", 0):
            return None
        if len(self._members) >= max_members():
            return None
        S = len(rt.counts_host)
        start_g = end_q - st.duration - info["offset"]
        fetch_lo = start_g - info["lookback"] - info["lookback_delta"]
        # the tile as one refresh left it (RollingTile.lock: a rolling
        # query may be appending to it)
        with rt.lock:
            if rt.lo_ms > fetch_lo:
                return None
            tiles = rt.tiles
            N = tile_shape(tiles)[1]
            # a series-sharded tile's shards come back in row order
            ts_full, vals_full = tile_cache.timed_transfer(
                "device:download", S * N * 12,
                lambda: (host_rows(tiles[0], S), host_rows(tiles[1], S)))
            counts = np.asarray(rt.counts_host, dtype=np.int32).copy()
            rt_base, rt_lo, rt_hi, rt_version = \
                rt.base_ms, rt.lo_ms, rt.hi_ms, rt.version
            row_of_raw, segments = dict(rt.row_of_raw), list(rt.segments)
        # crop to this stream's fetch bound and REBASE the origin there:
        # samples older than fetch_lo never contribute to this stream
        # again, and the crop bounds the bucket's columns at about the
        # window.  cutoff_rel may be negative (a cold tile's base is its
        # grid start, the lookback prefix sits below it): then nothing
        # drops and the rebase shifts every ts up
        cutoff_rel = fetch_lo - rt_base
        k = np.arange(ts_full.shape[1])[None, :]
        valid = k < counts[:, None]
        drop = ((ts_full < cutoff_rel) & valid).sum(axis=1).astype(np.int32)
        counts = counts - drop
        idx = np.clip(drop[:, None] + k, 0, ts_full.shape[1] - 1)
        ts_full = np.take_along_axis(
            ts_full.astype(np.int64), idx, axis=1) - cutoff_rel
        vals_full = np.take_along_axis(vals_full, idx, axis=1)
        base_ms = fetch_lo
        live = k < counts[:, None]
        ts_full = np.where(live, ts_full, TS_PAD).astype(np.int32)
        vals_full = np.where(live, vals_full, 0)
        n_need = int(counts.max()) if S else 1
        m = FleetMember()
        m.skey = info["skey"]
        m.stream_key = (st.tenant, st.q, st.step, st.duration)
        m.me = info["me"]
        m.tenant = st.tenant
        m.max_series = info["max_series"]
        m.func = info["func"]
        m.aggr = info["aggr"]
        m.step = st.step
        m.duration = st.duration
        m.window = info["window"]
        m.lookback = info["lookback"]
        m.lookback_delta = info["lookback_delta"]
        m.offset = info["offset"]
        m.drop_stale = info["drop_stale"]
        m.S = S
        m.G = len(group_keys)
        m.T = st.duration // st.step + 1
        m.group_keys = list(group_keys)
        m.gids = host_rows(groups.gids, S).astype(np.int32)
        m.base_ms = base_ms
        m.lo_ms = max(rt_lo, base_ms)
        m.hi_ms = rt_hi
        m.version = rt_version
        m.structural = rt.structural
        m.counts = counts.astype(np.int64)
        m.row_of_raw = row_of_raw
        m.segments = [(max(lo, base_ms), hi, nn)
                      for lo, hi, nn in segments if hi >= base_ms]
        key = (m.func, m.step, m.lookback, bucket_up(S),
               bucket_up(tile_capacity(n_need), 64), bucket_up(m.T),
               bucket_up(m.G))
        b = self._buckets.get(key)
        if b is None:
            b = self._buckets[key] = FleetBucket(key, self.n_stream())
        b._alloc(self.n_stream(), len(b.members) + 1)
        m.bucket = b
        m.slot = len(b.members)
        b.members.append(m)
        self._fill_slot(b, m, ts_full, vals_full)
        b.dirty = True
        self._members[m.skey] = m
        # the selector's rolling tile stays registered under its own key;
        # dropping the SHAPE entry routes this stream to the fleet
        wcache.invalidate(m.skey)
        self._rebuild_retry.pop(m.skey, None)
        self.adoptions += 1
        self.adopt_s += time.perf_counter() - t_adopt
        _ADOPTIONS.inc()
        flightrec.instant("fleet:adopt", arg=str(m.skey[1])[:120])
        return m

    def _fill_slot(self, b: FleetBucket, m: FleetMember,
                   ts: np.ndarray, vals: np.ndarray) -> None:
        S = ts.shape[0]
        # live columns all sit left of counts.max() <= N_b after the
        # adoption crop; the tail beyond the bucket's width is pure pad
        N = min(ts.shape[1], b.N_b)
        sl = m.slot
        b.ts_h[sl] = TS_PAD
        b.vals_h[sl] = 0
        b.counts_h[sl] = 0
        b.gids_h[sl] = 0
        b.v0_h[sl] = 0
        b.ts_h[sl, :S, :N] = ts[:, :N]
        b.vals_h[sl, :S, :N] = vals[:, :N]
        b.counts_h[sl, :S] = m.counts
        b.gids_h[sl, :S] = m.gids
        b.aggr_h[sl] = FLEET_AGGR_CODES[m.aggr]

    # -- advance (mirrors advance_rolling's guard set) --------------------

    def _advance_member(self, api, m: FleetMember, end_q: int):
        """Returns "ok" (nothing to append), "skip" (decline this interval,
        keep the member), "evict", or (cols, rows_idx) staged append
        columns."""
        def no(reason: str) -> str:
            self.last_decline = reason
            return "evict"

        storage = api.storage
        start_g = end_q - m.duration - m.offset
        end_g = end_q - m.offset
        fetch_lo = start_g - m.lookback - m.lookback_delta
        ver = getattr(storage, "data_version", None)
        if ver is None or \
                getattr(storage, "structural_version", None) != m.structural:
            return no("deletes/retention changed visible data")
        if getattr(storage, "dedup_interval_ms", 0):
            return no("dedup interval set")
        if m.lo_ms > fetch_lo:
            return no("member history does not reach the lookback")
        if start_g < m.base_ms:
            return no("query starts before the member's rebase origin")
        if end_g - m.base_ms >= 2**31 - 1:
            if not self._compact(m.bucket, {m.slot: fetch_lo}) or \
                    end_g - m.base_ms >= 2**31 - 1:
                return no("int32 rebase exhausted")
        if ver != m.version:
            try:
                lo_new = storage.min_appended_since(m.version)
            except LookupError:
                return no("append log trimmed past member version")
            if lo_new is not None and lo_new <= m.hi_ms:
                return no("late data landed inside the covered range")
        staged = "ok"
        if end_g > m.hi_ms:
            filters = filters_from_metric_expr(m.me, storage)
            if hasattr(storage, "reset_partial"):
                storage.reset_partial()
            try:
                cols = storage.search_columns(filters, m.hi_ms + 1, end_g,
                                              max_series=m.max_series,
                                              tenant=m.tenant)
            except Exception:  # noqa: BLE001 — limits etc: per-stream path
                return no("slice fetch failed")
            if getattr(storage, "last_partial", False):
                # never commit a partial interval; retry next interval
                self.last_decline = "partial slice fetch"
                return "skip"
            if m.drop_stale:
                cols.drop_stale_nans()
            if cols.n_series:
                staged = self._stage_append(m, cols, fetch_lo)
                if isinstance(staged, str):
                    return no(staged)
                m.segments.append((m.hi_ms + 1, end_g, cols.n_samples))
            m.hi_ms = end_g
        m.version = ver
        return staged

    def _stage_append(self, m: FleetMember, cols, fetch_lo: int):
        """Validate and index one fetched slice for the batched append.
        Returns (cols, rows_idx) or a decline reason."""
        rows_idx = np.empty(cols.n_series, dtype=np.int64)
        for i, rn in enumerate(cols.raw_names):
            r = m.row_of_raw.get(rn)
            if r is None:
                return "new series appeared"
            rows_idx[i] = r
        new_n = m.counts[rows_idx] + cols.counts
        if int(new_n.max()) > m.bucket.N_b:
            if not self._compact(m.bucket, {m.slot: fetch_lo}):
                return "column headroom exhausted"
            new_n = m.counts[rows_idx] + cols.counts
            if int(new_n.max()) > m.bucket.N_b:
                return "column headroom exhausted"
        return (cols, rows_idx)

    # -- packing: mirrors + device ----------------------------------------

    def _stage_to_mirror(self, b: FleetBucket, staged) -> None:
        """Apply staged appends to the bucket's host mirrors (the scatter
        B10 performs on the device planes)."""
        for m, cols, rows_idx in staged:
            K = cols.ts.shape[1]
            live = np.arange(K)[None, :] < cols.counts[:, None]
            r_i, k_i = np.nonzero(live)
            rows = rows_idx[r_i]
            col = m.counts[rows] + k_i
            rel = (cols.ts - m.base_ms).astype(np.int64)
            b.ts_h[m.slot, rows, col] = rel[r_i, k_i].astype(np.int32)
            b.vals_h[m.slot, rows, col] = cols.vals[r_i, k_i]
            new_n = m.counts[rows_idx] + cols.counts
            m.counts[rows_idx] = new_n
            b.counts_h[m.slot, rows_idx] = new_n.astype(np.int32)

    def _put(self, name: str, a: np.ndarray):
        """A private device copy of a host array (B10 writes the planes in
        place, so they must never alias a mirror): one tensor, or on a
        mesh the per-shard slices of its stream axis per the partition
        rules (`name`)."""
        return shard_put(self._mesh, name, a, device=self.engine.device)

    def _upload(self, b: FleetBucket) -> None:
        """Full mirror -> device upload (adoption, eviction repack), with
        the bucket's group layout built once for the members it holds
        (one per stream shard on a mesh)."""
        t0 = time.perf_counter()
        b.dev = {"ts": self._put("fleet_ts", b.ts_h),
                 "vals": self._put("fleet_values", b.vals_h),
                 "counts": self._put("fleet_counts", b.counts_h),
                 "v0": self._put("fleet_v0", b.v0_h),
                 "aggr": self._put("fleet_aggr", b.aggr_h),
                 "layout": per_shard(
                     lambda g: fleet_layout(g, b.G_b, g.device),
                     self._put("fleet_gids", b.gids_h))}
        b.last_up_wall = time.perf_counter() - t0
        b.last_up_bytes = (b.ts_h.nbytes + b.vals_h.nbytes +
                           b.counts_h.nbytes + b.gids_h.nbytes +
                           b.v0_h.nbytes + b.aggr_h.nbytes)
        b.dirty = False

    def _append_device(self, b: FleetBucket, staged) -> None:
        """One batched append (B10) for every staged slice of this bucket
        (no-op rows for members with nothing staged)."""
        if not staged:
            b.last_up_bytes = 0
            b.last_up_wall = 0.0
            return
        t0 = time.perf_counter()
        K = max(int(c.ts.shape[1]) for _, c, _ in staged)
        K_pad = (K + 7) // 8 * 8
        new_ts = np.zeros((b.B_pad, b.S_b, K_pad), dtype=np.int32)
        new_vals = np.zeros((b.B_pad, b.S_b, K_pad), dtype=np.float64)
        new_counts = np.zeros((b.B_pad, b.S_b), dtype=np.int32)
        for m, cols, rows_idx in staged:
            Kc = cols.ts.shape[1]
            new_ts[m.slot, rows_idx, :Kc] = \
                (cols.ts - m.base_ms).astype(np.int32)
            new_vals[m.slot, rows_idx, :Kc] = cols.vals
            new_counts[m.slot, rows_idx] = cols.counts
        dev = b.dev
        timed_kernel_call("fleet_append_tile", per_shard, fleet_append_tile,
                          dev["ts"], dev["vals"], dev["counts"],
                          self._put("fleet_ts", new_ts),
                          self._put("fleet_values", new_vals),
                          self._put("fleet_counts", new_counts))
        b.last_up_wall = time.perf_counter() - t0
        b.last_up_bytes = (new_ts.nbytes + new_vals.nbytes +
                           new_counts.nbytes)

    def _compact(self, b: FleetBucket, cutoffs: dict) -> bool:
        """Window-slide compaction for the slots in `cutoffs` ({slot:
        absolute cutoff}): mirrors AND device planes (one B11 launch over
        every slot, cutoff 0 for the others) drop samples older than each
        member's cutoff and rebase its origin there."""
        cut_rel = np.zeros(b.B_pad, dtype=np.int64)
        todo = []
        for m in b.members:
            c = cutoffs.get(m.slot)
            if c is None:
                continue
            rel = c - m.base_ms
            if rel <= 0:
                return False  # nothing would move
            if rel >= 2**31 - 1:
                return False  # stale beyond the int32 frame: evict path
            cut_rel[m.slot] = rel
            todo.append((m, c, rel))
        if not todo:
            return False
        # host mirrors (authoritative): per-slot crop, the semantics of
        # B11 (drop ts < cutoff, shift left, rebase)
        k = np.arange(b.N_b)[None, :]
        for m, cutoff_abs, rel in todo:
            ts = b.ts_h[m.slot].astype(np.int64)
            counts = b.counts_h[m.slot].astype(np.int64)
            valid = k < counts[:, None]
            drop = ((ts < rel) & valid).sum(axis=1)
            new_counts = counts - drop
            idx = np.clip(drop[:, None] + k, 0, b.N_b - 1)
            ts2 = np.take_along_axis(ts, idx, axis=1) - rel
            v2 = np.take_along_axis(b.vals_h[m.slot], idx, axis=1)
            live = k < new_counts[:, None]
            b.ts_h[m.slot] = np.where(live, ts2, TS_PAD).astype(np.int32)
            b.vals_h[m.slot] = np.where(live, v2, 0)
            b.counts_h[m.slot] = new_counts.astype(np.int32)
            m.counts = new_counts[:m.S].copy()
            m.base_ms = cutoff_abs
            m.lo_ms = max(m.lo_ms, cutoff_abs)
            m.segments = [(max(lo, cutoff_abs), hi, nn)
                          for lo, hi, nn in m.segments if hi >= cutoff_abs]
        if b.dev is not None and not b.dirty:
            cut_d = self._put("fleet_shift", cut_rel.astype(np.int32))
            out = timed_kernel_call("fleet_compact_tile", per_shard,
                                    fleet_compact_tile, b.dev["ts"],
                                    b.dev["vals"], b.dev["counts"], cut_d,
                                    cut_d)
            b.dev["ts"], b.dev["vals"], b.dev["counts"] = out
            tile_cache.count_window_compaction()
        return True

    # -- eviction ---------------------------------------------------------

    def _evict(self, m: FleetMember, reason: str) -> None:
        b = m.bucket
        self._members.pop(m.skey, None)
        self._results.pop(m.skey, None)
        self._rebuild_retry[m.skey] = 4
        last = b.members[-1]
        if last is not m:
            # swap-remove: the last slot's planes move into the hole
            b.ts_h[m.slot] = b.ts_h[last.slot]
            b.vals_h[m.slot] = b.vals_h[last.slot]
            b.counts_h[m.slot] = b.counts_h[last.slot]
            b.gids_h[m.slot] = b.gids_h[last.slot]
            b.v0_h[m.slot] = b.v0_h[last.slot]
            b.aggr_h[m.slot] = b.aggr_h[last.slot]
            b.members[m.slot] = last
            last.slot = m.slot
        b.members.pop()
        sl = len(b.members)
        b.ts_h[sl] = TS_PAD
        b.vals_h[sl] = 0
        b.counts_h[sl] = 0
        b.gids_h[sl] = 0
        b.v0_h[sl] = 0
        b.aggr_h[sl] = 0
        b.dirty = True
        if not b.members:
            self._buckets.pop(b.key, None)
        self.evictions += 1
        _EVICTIONS.inc()
        flightrec.instant("fleet:evict",
                          arg=f"{reason}: {str(m.skey[1])[:100]}")

    # -- the fused launch -------------------------------------------------

    def _launch(self, api, b: FleetBucket, due) -> None:
        shift = np.zeros(b.B_pad, dtype=np.int32)
        min_ts = np.zeros(b.B_pad, dtype=np.int32)
        for m, end_q in due:
            start_g = end_q - m.duration - m.offset
            shift[m.slot] = start_g - m.base_ms
            min_ts[m.slot] = -(m.lookback + m.lookback_delta)
        t0 = time.perf_counter()
        dev = b.dev
        args = (dev["ts"], dev["vals"], dev["counts"], dev["layout"],
                dev["aggr"], self._put("fleet_shift", shift),
                self._put("fleet_min_ts", min_ts), dev["v0"])
        if self._mesh is not None:
            # B14: B9 on each stream shard's slice, one [B, G, T] output
            fn = meshlib.cached_fleet_rollup_aggregate(self._mesh, b.func,
                                                       b.cfg, b.G_b)
            out = timed_kernel_call("fleet_rollup_aggregate_tile", fn,
                                    *args)
        else:
            ts, vals, counts, layout, aggr, sh, mt, v0 = args
            out = timed_kernel_call("fleet_rollup_aggregate_tile",
                                    fleet_rollup_aggregate_tile, b.func,
                                    b.cfg, layout, ts, vals, counts, aggr,
                                    sh, mt, v0)
        out_h = _pull_host(out)
        wall = time.perf_counter() - t0
        ver = getattr(api.storage, "data_version", None)
        structural = getattr(api.storage, "structural_version", None)
        # rows-share split of the shared launch: the LAST member takes the
        # exact remainder so per-stream shares sum to the total
        total_S = sum(m.S for m, _ in due) or 1
        acc_w = acc_uw = 0.0
        acc_b = 0
        for i, (m, end_q) in enumerate(due):
            start_g = end_q - m.duration - m.offset
            r = FleetResult()
            r.start = start_g
            r.end = end_q - m.offset
            r.step = m.step
            r.version = ver
            r.structural = structural
            r.lookback_delta = m.lookback_delta
            r.rows = out_h[m.slot, :m.G, :m.T].copy()
            r.group_keys = m.group_keys
            r.samples = m.samples_in_range(
                start_g - m.lookback - m.lookback_delta)
            if i + 1 == len(due):
                r.exec_share_s = wall - acc_w
                r.up_share_s = b.last_up_wall - acc_uw
                r.up_share_b = b.last_up_bytes - acc_b
            else:
                frac = m.S / total_S
                r.exec_share_s = wall * frac
                r.up_share_s = b.last_up_wall * frac
                r.up_share_b = int(b.last_up_bytes * frac)
            acc_w += r.exec_share_s
            acc_uw += r.up_share_s
            acc_b += r.up_share_b
            self._results[m.skey] = r
        b.last_up_bytes = 0
        b.last_up_wall = 0.0
        self.launches += 1
        _LAUNCHES.inc()
        _STREAMS.inc(len(due))
        flightrec.rec(
            "device:fleet_launch", t0, wall,
            arg=f"{len(due)}/{len(b.members)} streams "
                f"[B={b.B_pad},S={b.S_b},N={b.N_b},G={b.G_b},T={b.T_b}]")


# -- module-level seams ------------------------------------------------------


def prepass(api, now_ms: int) -> int:
    """Interval hook, called before the streams evaluate: one fleet run.
    Never raises: a fleet failure leaves the interval to the per-stream
    paths, loudly on stderr.  (A caller that must see the fault calls
    ``engine.fleet().run`` itself.)"""
    eng = getattr(api, "tpu", None)
    if eng is None or not enabled() or \
            not tile_cache.device_resident_enabled():
        return 0
    try:
        return eng.fleet().run(api, now_ms)
    except Exception as e:  # noqa: BLE001 — serving must survive
        flightrec.instant("fleet:error", arg=repr(e)[:160])
        print(f"vmtorch: fleet prepass failed (per-stream fallback): {e!r}",
              file=sys.stderr)
        return 0


def resident(engine, skey) -> bool:
    """True when the fleet holds a member for this roll-state key, or the
    key was recently evicted and should run one full device evaluation to
    rebuild its per-shape window so the fleet can re-adopt it."""
    if engine is None or not enabled():
        return False
    plane = engine._fleet
    return plane is not None and \
        (plane.has(skey) or plane.wants_rebuild(skey))


def take(ec, skey):
    """Serve one evaluation from the fleet's result table: (rows [G, T],
    group_keys) on a grid- and version-matched result, else None (the
    evaluation falls through to the per-stream paths).  `ec` is the
    query's EvalConfig (its engine is ``ec.tpu``).  Counts samples, checks
    the deadline, and laps this stream's share of the shared launch into
    the query's cost tracker (consumed once)."""
    eng = ec.tpu
    if eng is None or not enabled():
        return None
    plane = eng._fleet
    if plane is None or not tile_cache.device_resident_enabled():
        return None
    with plane._lock:
        r = plane._results.get(skey)
        m = plane._members.get(skey)
        if r is None or m is None:
            return None
        if (r.start, r.end, r.step) != (ec.start - m.offset,
                                        ec.end - m.offset, ec.step):
            return None
        if r.version != getattr(ec.storage, "data_version", None) or \
                r.structural != getattr(ec.storage, "structural_version",
                                        None) or \
                r.lookback_delta != ec.lookback_delta:
            return None
        rows, group_keys, samples = r.rows, r.group_keys, r.samples
        exec_s, up_s, up_b = r.exec_share_s, r.up_share_s, r.up_share_b
        r.exec_share_s = r.up_share_s = 0.0
        r.up_share_b = 0
        plane.served += 1
    ec.check_deadline()
    ec.count_samples(samples)
    tr = costacc.current()
    if tr is not None:
        if exec_s:
            tr.lap("device:execute", exec_s, 0.0)
        if up_s or up_b:
            tr.lap("device:upload", up_s, 0.0)
            tr.add_device(up=up_b)
    _SERVED.inc()
    return rows, group_keys
