"""CUDA query backend: fused ``aggr(rollup(selector[window]))`` on device
tiles, as a cold query and as a rolling refresh.

Port of the fused and rolling paths of ``victoriametrics_tpu/query/
tpu_engine.py`` (functions keep their reference names without the
``_tpu`` suffix):

- cold: ``try_aggr_rollup`` -> ``_upload_tiles`` (host float->decimal,
  nearest-delta2 planes, H2D, K1 ``decode_tiles``) -> ``_dispatch_fused``
  (K2 ``rollup_aggregate_tile``) -> the [G, T] result back to the host;
- rolling: ``advance_rolling`` fetches only the slice newer than the
  resident tile from a storage (duck-typed: ``search_columns``,
  ``data_version``, ``structural_version``, ``min_appended_since``,
  ``last_partial``, ``dedup_interval_ms``) and appends it with K3
  ``append_tile``; ``compact_window`` slides the window with K4
  ``compact_tile``; ``run_fused_on_tiles`` runs K2 on the resident tile.

The engine is float64 only (the H100 computes float64 natively; the
reference's float32 rebase tiles exist because the TPU does not).  Rollup
funcs and aggregates outside K2's set return None: the reference engine's
"not on device" contract, which its callers answer on the host.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time

import numpy as np
import torch

from .. import kernels
from ..models import tile_cache
from ..ops import decimal as dec
from ..ops import device_decode as dd
from ..ops.device_rollup import (AGGR_FUNCS, FUSED_FUNCS, MIN_TS_NONE,
                                 GroupLayout, append_tile, compact_tile,
                                 group_layout, normalized_cfg, pack_series,
                                 rollup_aggregate_tile)
from ..ops.rollup_np import CORE_SUPPORTED, RollupConfig
from ..utils import metrics as metricslib

FUSED_AGGRS = frozenset(AGGR_FUNCS)

# (kernel, phase) -> histogram handle, off the per-dispatch path
_kernel_hist_memo: dict = {}


def _kernel_histogram(kernel: str, phase: str):
    key = (kernel, phase)
    h = _kernel_hist_memo.get(key)
    if h is None:
        h = _kernel_hist_memo[key] = metricslib.REGISTRY.histogram(
            metricslib.format_name("vm_tpu_kernel_duration_seconds",
                                   {"kernel": kernel, "phase": phase}))
    return h


def _synchronize(out) -> None:
    items = out if isinstance(out, tuple) else (out,)
    for t in items:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


def timed_kernel_call(kernel: str, fn, *args, **kw):
    """Run a kernel wrapper and record its wall time, synchronised with the
    card, into vm_tpu_kernel_duration_seconds{kernel, phase}.  The phase is
    "compile" for a call that had to build or load a kernel library first,
    "execute" otherwise."""
    loads = kernels.loads()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    _synchronize(out)
    dt = time.perf_counter() - t0
    phase = "compile" if kernels.loads() > loads else "execute"
    _kernel_histogram(kernel, phase).update(dt)
    return out


def _pull_host(out: torch.Tensor) -> np.ndarray:
    """D2H pull of a kernel result with byte accounting — the one seam
    where device results cross back to the host."""
    nbytes = out.numel() * out.element_size()
    return tile_cache.timed_transfer(
        "device:download", nbytes,
        lambda: out.to("cpu").numpy().astype(np.float64, copy=False))


@dataclasses.dataclass
class CUDAEngine:
    """The port's device engine: one card (``device="cuda"``), or the plain
    PyTorch versions when a caller asks for ``device="cpu"``."""
    device: object = "cuda"
    cache_bytes: int = 2 << 30
    min_series: int = 64         # below this the host path wins
    last_roll_decline: str = ""  # why the last rolling advance fell back
    _cache: object = None
    _aux: object = None
    _wcache: object = None

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDAEngine: no CUDA device is available "
                               "(pass device='cpu' for the plain versions)")

    def cache(self) -> tile_cache.TileCache:
        if self._cache is None:
            self._cache = tile_cache.TileCache(self.cache_bytes)
        return self._cache

    def window_cache(self) -> tile_cache.DeviceWindowCache:
        """Device-resident rolling windows: the state that makes a rolling
        refresh upload only its new columns."""
        if self._wcache is None:
            self._wcache = tile_cache.DeviceWindowCache()
        return self._wcache


def _fingerprint(series, start_ms: int) -> tuple:
    h = hashlib.blake2b(digest_size=8)
    for sd in series:
        raw = getattr(sd, "raw_name", None)
        h.update(raw if raw is not None else sd.metric_name.marshal())
        h.update(np.int64(sd.timestamps.size).tobytes())
        if sd.timestamps.size:
            h.update(np.int64(sd.timestamps[-1]).tobytes())
    return ("tile", int.from_bytes(h.digest(), "little"), start_ms)


def try_aggr_rollup(engine: CUDAEngine, aggr: str, func: str, series,
                    gids, num_groups: int, cfg: RollupConfig,
                    cache_key=None):
    """Fused aggr(rollup(selector)) on device: per-series rollup and
    segment aggregation in one kernel, so only the [G, T] aggregate
    crosses back to the host.  Returns a float64 [G, T] array, or None when
    the query is not one the device runs."""
    if aggr not in FUSED_AGGRS or func not in FUSED_FUNCS or \
            func not in CORE_SUPPORTED:
        return None
    if len(series) < engine.min_series:
        return None
    span = cfg.end - cfg.start + cfg.lookback
    if span >= 2**31 - 1:
        return None
    key = cache_key or _fingerprint(series, cfg.start)
    cache = engine.cache()
    tiles = cache.get(key)
    if tiles is None:
        tiles = _upload_tiles(engine, series, cfg)
        cache.put_device(key, tiles)
    return _dispatch_fused(engine, aggr, func, tiles,
                           group_layout(gids, num_groups, engine.device), cfg)


def warmup(engine: CUDAEngine, funcs=("rate", "increase"),
           aggrs=("sum",)) -> int:
    """Build and load the kernels and run the fused query once on a small
    canonical shape, so the first real query pays neither.  Returns the
    number of queries run.  A kernel that fails to build or launch raises."""
    from ..storage.storage import SeriesData
    S, N = max(int(engine.min_series), 64), 128
    start = (int(time.time() * 1000) - N * 15_000) // 60_000 * 60_000
    rng = np.random.default_rng(7)
    series = []
    for i in range(S):
        ts = np.arange(N, dtype=np.int64) * 15_000 + start
        v = np.cumsum(rng.integers(0, 50, N)).astype(np.float64)
        series.append(SeriesData(None, ts, v, raw_name=b"__warmup__%d" % i))
    cfg = RollupConfig(start=start + 600_000, end=start + (N - 1) * 15_000,
                       step=60_000, window=300_000)
    gids = np.zeros(S, np.int32)
    n_runs = 0
    for func in funcs:
        for aggr in aggrs:
            if try_aggr_rollup(engine, aggr, func, series, gids, 1,
                               cfg) is not None:
                n_runs += 1
    return n_runs


def _dispatch_fused(engine: CUDAEngine, aggr: str, func: str, tiles,
                    groups: GroupLayout, cfg: RollupConfig, shift: int = 0,
                    min_ts=None) -> np.ndarray:
    """Run K2 on a tile and pull the [G, T] result.  `shift` rebases
    rolling-tile timestamps onto the query grid and `min_ts` reproduces
    fetch truncation on over-covering tiles."""
    if min_ts is None:
        min_ts = MIN_TS_NONE
    ts_t, v_t, counts = tiles
    out = timed_kernel_call("rollup_aggregate_tile", rollup_aggregate_tile,
                            func, aggr, ts_t, v_t, counts, groups,
                            normalized_cfg(func, cfg), int(shift),
                            int(min_ts))
    return _pull_host(out)


def _upload_tiles(engine: CUDAEngine, series, cfg: RollupConfig):
    """Cold upload: compact delta planes decoded on device (~2-5
    B/sample over the link); dense tiles when the data needs >int32."""
    put = tile_cache.chunked_device_put
    triples = []
    for sd in series:
        m, e = dec.float_to_decimal(sd.values)
        triples.append((sd.timestamps, m, e))
    planes = dd.pack_delta_planes(triples, cfg.start)
    if planes is not None:
        n = int(planes.counts.max())
        n_cap = tile_capacity(n)
        if n_cap > n:
            # headroom columns for rolling appends: zero d2 planes decode
            # into tails that every kernel masks out via counts
            pad = max(n_cap - 2 - planes.ts_d2.shape[1], 0)
            planes = dataclasses.replace(
                planes,
                ts_d2=np.pad(planes.ts_d2, ((0, 0), (0, pad))),
                val_d2=np.pad(planes.val_d2, ((0, 0), (0, pad))))
        dev = [put(getattr(planes, f.name), engine.device)
               for f in dataclasses.fields(planes)]
        ts_t, v_t = timed_kernel_call("decode_tiles", dd.decode_tiles, *dev,
                                      n_cap)
        return ts_t, v_t, dev[7]
    ts, vals, counts = pack_series(
        [(sd.timestamps, sd.values) for sd in series], cfg.start,
        n_pad=tile_capacity(
            max((sd.timestamps.size for sd in series), default=1)))
    return (put(ts, engine.device), put(vals, engine.device),
            put(counts, engine.device))


def tile_capacity(n: int) -> int:
    """Column capacity for a freshly built tile: ~25% headroom (min 32
    columns) rounded to a multiple of 64, so rolling appends have room."""
    return (max(n + 32, n * 5 // 4) + 63) // 64 * 64


class RollingTile:
    """A device-resident tile that advances with append-only ingest
    instead of rebuilding: new samples land in reserved column headroom
    (K3) and the query grid moves by a shift.

    The append writes the resident tensors in place and the compaction
    replaces them; anything else holding them (the exact-key TileCache
    entry the tile was adopted from, `adopted_key`) is invalidated first."""

    __slots__ = ("tiles", "base_ms", "n_cap", "lo_ms", "hi_ms", "version",
                 "structural", "counts_host", "row_of_raw", "n_samples",
                 "adopted_key", "appends", "segments")

    def __init__(self, tiles, base_ms, n_cap, lo_ms, hi_ms, version,
                 structural, counts_host, row_of_raw, n_samples,
                 adopted_key):
        self.tiles = tiles
        self.base_ms = base_ms
        self.n_cap = n_cap
        self.lo_ms = lo_ms
        self.hi_ms = hi_ms
        self.version = version
        self.structural = structural
        self.counts_host = counts_host
        self.row_of_raw = row_of_raw
        self.n_samples = n_samples
        self.adopted_key = adopted_key
        self.appends = 0
        # (seg_lo, seg_hi, n) per build/append: sample accounting charges
        # only the segments a query's fetch range touches
        self.segments = [(lo_ms, hi_ms, n_samples)]

    def samples_in_range(self, fetch_lo: int) -> int:
        return sum(n for _, seg_hi, n in self.segments if seg_hi >= fetch_lo)


def advance_rolling(engine: CUDAEngine, rt: RollingTile, storage, filters,
                    start: int, fetch_lo: int, end: int, max_series, tenant,
                    drop_stale: bool) -> bool:
    """Bring `rt` up to date with storage for a query fetching
    [fetch_lo, end]: fetch only the slice newer than the tile's covered
    range and append it on device.  Returns False when the tile cannot be
    advanced (late/backfilled data, deletes, new series, capacity/int32
    exhausted); the caller then rebuilds through the cold path."""
    def no(reason: str) -> bool:
        engine.last_roll_decline = reason
        return False

    if not tile_cache.device_resident_enabled():
        return no("VM_DEVICE_RESIDENT=0")
    ver = getattr(storage, "data_version", None)
    if ver is None or \
            getattr(storage, "structural_version", None) != rt.structural:
        return no("deletes/retention changed visible data")
    if getattr(storage, "dedup_interval_ms", 0):
        return no("dedup interval set")  # buckets could straddle the append
    if rt.lo_ms > fetch_lo:
        return no("tile history does not reach this query's lookback")
    if start < rt.base_ms:
        # a negative shift would wrap the TS_PAD sentinel in int32
        return no("query starts before the tile's rebase origin")
    if end - rt.base_ms >= 2**31 - 1:
        if not compact_window(engine, rt, fetch_lo) or \
                end - rt.base_ms >= 2**31 - 1:
            return no("int32 rebase exhausted")
    if ver != rt.version:
        try:
            lo_new = storage.min_appended_since(rt.version)
        except LookupError:
            return no("append log trimmed past tile version")
        if lo_new is not None and lo_new <= rt.hi_ms:
            return no("late data landed inside the covered range")
    if end > rt.hi_ms:
        cols = storage.search_columns(filters, rt.hi_ms + 1, end,
                                      max_series=max_series, tenant=tenant)
        if getattr(storage, "last_partial", False):
            return no("partial slice fetch")
        if drop_stale:
            cols.drop_stale_nans()
        if cols.n_series:
            if not _append_cols(engine, rt, cols, fetch_lo):
                return no(engine.last_roll_decline)
            rt.segments.append((rt.hi_ms + 1, end, cols.n_samples))
        rt.hi_ms = end
    rt.version = ver
    return True


def compact_window(engine: CUDAEngine, rt: RollingTile,
                   cutoff_abs: int) -> bool:
    """Slide the resident window on device: drop every sample older than
    `cutoff_abs` (this query's fetch lower bound) and rebase the tile
    origin there (K4), freeing column headroom and int32 range without a
    re-upload.  Returns False when nothing would move."""
    cutoff_rel = cutoff_abs - rt.base_ms
    if cutoff_rel <= 0 or cutoff_rel >= 2**31 - 1:
        return False
    if rt.adopted_key is not None:
        engine.cache().invalidate(rt.adopted_key)
        rt.adopted_key = None
    ts_t, v_t, counts_t = rt.tiles
    new_ts, new_vals, new_counts = timed_kernel_call(
        "compact_tile", compact_tile, ts_t, v_t, counts_t, int(cutoff_rel),
        int(cutoff_rel))
    counts_host = tile_cache.timed_transfer(
        "device:download", new_counts.numel() * 4,
        lambda: new_counts.to("cpu").numpy().astype(np.int64))
    rt.tiles = (new_ts, new_vals, new_counts)
    rt.counts_host = counts_host
    rt.n_samples = int(counts_host.sum())
    rt.base_ms = cutoff_abs
    rt.lo_ms = max(rt.lo_ms, cutoff_abs)
    rt.segments = [(max(lo, cutoff_abs), hi, n)
                   for lo, hi, n in rt.segments if hi >= cutoff_abs]
    tile_cache.count_window_compaction()
    return True


def _append_cols(engine: CUDAEngine, rt: RollingTile, cols,
                 fetch_lo: int) -> bool:
    """Scatter a fetched slice (ColumnarSeries) onto the tile tails."""
    rows_idx = np.empty(cols.n_series, dtype=np.int64)
    for i, rn in enumerate(cols.raw_names):
        r = rt.row_of_raw.get(rn)
        if r is None:
            engine.last_roll_decline = "new series appeared"
            return False
        rows_idx[i] = r
    new_n = rt.counts_host[rows_idx] + cols.counts
    if int(new_n.max()) > rt.n_cap:
        # window-slide compaction before giving up
        if not compact_window(engine, rt, fetch_lo):
            engine.last_roll_decline = "column headroom exhausted"
            return False
        new_n = rt.counts_host[rows_idx] + cols.counts
        if int(new_n.max()) > rt.n_cap:
            engine.last_roll_decline = "column headroom exhausted"
            return False
    ts_t, v_t, counts_t = rt.tiles
    S_tile = int(ts_t.shape[0])
    K = int(cols.ts.shape[1])
    K_pad = (K + 7) // 8 * 8  # few distinct append shapes
    new_ts = np.zeros((S_tile, K_pad), dtype=np.int32)
    new_vals = np.zeros((S_tile, K_pad), dtype=np.float64)
    new_counts = np.zeros(S_tile, dtype=np.int32)
    new_ts[rows_idx, :K] = (cols.ts - rt.base_ms).astype(np.int32)
    new_vals[rows_idx, :K] = cols.vals
    new_counts[rows_idx] = cols.counts
    if rt.adopted_key is not None:
        engine.cache().invalidate(rt.adopted_key)
        rt.adopted_key = None
    put = tile_cache.chunked_device_put
    timed_kernel_call("append_tile", append_tile, ts_t, v_t, counts_t,
                      put(new_ts, engine.device),
                      put(new_vals, engine.device),
                      put(new_counts, engine.device))
    rt.counts_host[rows_idx] = new_n
    rt.n_samples += cols.n_samples
    rt.appends += 1
    return True


def aux_cache(engine: CUDAEngine):
    """Host-side LRU mapping a query-shape key to what a warm fused query
    needs to skip the host fetch and go straight to the resident tile."""
    if engine._aux is None:
        from collections import OrderedDict
        engine._aux = OrderedDict()
    return engine._aux


def aux_get(engine: CUDAEngine, key):
    aux = aux_cache(engine)
    hit = aux.get(key)
    if hit is not None:
        aux.move_to_end(key)
    return hit


def aux_put(engine: CUDAEngine, key, value, cap: int = 1024):
    aux = aux_cache(engine)
    aux[key] = value
    aux.move_to_end(key)
    while len(aux) > cap:
        aux.popitem(last=False)


def run_fused_on_tiles(engine: CUDAEngine, aggr: str, func: str, tiles,
                       groups: GroupLayout, cfg: RollupConfig,
                       shift: int = 0, min_ts=None) -> np.ndarray:
    """Fused kernel over a device-resident tile (the warm and rolling
    path: no host fetch, no upload)."""
    return _dispatch_fused(engine, aggr, func, tiles, groups, cfg, shift,
                           min_ts)
