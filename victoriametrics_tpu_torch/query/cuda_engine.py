"""CUDA query backend: rollups over device tiles, per series, fused with
an aggregate, topk/bottomk and quantile, as a cold query and as a rolling
refresh.

Port of the single-card entry points of ``victoriametrics_tpu/query/
tpu_engine.py`` (functions keep their reference names without the
``_tpu`` suffix):

- per series: ``try_rollup`` -> B5 ``rollup_tile`` -> [S, T] rows;
- selection: ``try_topk_rollup`` -> B6 ``topk_select_tile`` +
  ``take_rows`` (topk/bottomk), or B7 ``rank_tile`` + ``take_rows``
  (topk_<kind>/bottomk_<kind>), only the chosen rows back to the host;
- quantile: ``try_quantile_rollup`` / ``run_quantile_on_tiles`` -> B8
  ``rollup_quantile_tile`` -> [G, T];

- cold: ``try_aggr_rollup`` -> ``_upload_tiles`` (``host_planes``: one
  grouped float->decimal and one flat nearest-delta2 pack for all the
  series; H2D, K1 ``decode_tiles``) -> ``_dispatch_fused``
  (K2 ``rollup_aggregate_tile``) -> the [G, T] result back to the host;
- rolling: ``advance_rolling`` fetches only the slice newer than the
  resident tile from a storage (duck-typed: ``search_columns``,
  ``data_version``, ``structural_version``, ``min_appended_since``,
  ``last_partial``, ``dedup_interval_ms``) and appends it with K3
  ``append_tile``; ``compact_window`` slides the window with K4
  ``compact_tile``; ``run_fused_on_tiles`` runs K2 on the resident tile;
  ``register_window`` files a query shape's rolling window under its
  roll-state key (``device_roll_keys``), where the fleet
  (``CUDAEngine.fleet()``, ``query/fleet.py``: B9-B11) adopts it.

With a mesh (``CUDAEngine(mesh=parallel.mesh.make_mesh(...))``, the
reference's ``TPUEngine(mesh=...)``) a tile's rows are padded to a
multiple of the series axis and split into per-shard row blocks (a list
of tensors), each on its shard's device: K1, K3, K4 and B5 run per
shard, the fused aggregate is B13 (``sharded_rollup_aggregate``: each
shard's moments, combined in shard order), and the selections and
quantiles run B6/B7/B8 on the shards' rollups gathered onto the first
device.  Padded rows have count 0 and group 0 and come back from no
entry point.  ``auto_mesh`` keeps the reference's rule: no mesh below two
cards, so one card serves unsharded.

The engine is float64 only (the H100 computes float64 natively; the
reference's float32 rebase tiles exist because the TPU does not), so the
reference's func_mode is always "direct" here.  Queries the reference
engine declines (funcs outside CORE_SUPPORTED, rollup args, too few
series, an int32-overflowing span, a quantile over the dense budget)
return None: its "not on device" contract, which callers answer on the
host.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time

import numpy as np
import torch

from .. import kernels
from ..devtools.locktrace import make_rlock
from ..models import tile_cache
from ..ops import decimal as dec
from ..ops import device_decode as dd
from ..ops.device_rollup import (AGGR_FUNCS, MIN_TS_NONE, TIME_VALUED_FUNCS,
                                 TS_PAD, GroupLayout, append_tile,
                                 compact_tile, group_layout, normalized_cfg,
                                 num_steps, pack_series, quantile_groups,
                                 rank_rows, rollup_aggregate_tile,
                                 rollup_tile, take_rows, topk_select)
from ..ops.rollup_np import CORE_SUPPORTED, RollupConfig
from ..parallel import mesh as meshlib
from ..parallel.partition import AXIS_SERIES, host_rows, per_shard, shard_put
from ..utils import costacc as _costacc
from ..utils import fasttime
from ..utils import flightrec as _flightrec
from ..utils import metrics as metricslib
from .rollup_funcs import ADJUSTABLE_WINDOW_FUNCS

FUSED_AGGRS = frozenset(AGGR_FUNCS)

# (kernel, phase) -> histogram handle, off the per-dispatch path
_kernel_hist_memo: dict = {}


def _kernel_histogram(kernel: str, phase: str):
    key = (kernel, phase)
    h = _kernel_hist_memo.get(key)
    if h is None:
        # benign double-create: REGISTRY.histogram dedups by name, so
        # two racing fills store the same object
        h = _kernel_hist_memo[key] = metricslib.REGISTRY.histogram(  # vmt: disable=VMT015
            metricslib.format_name("vm_tpu_kernel_duration_seconds",
                                   {"kernel": kernel, "phase": phase}))
    return h


def _cuda_devices(out):
    if isinstance(out, (tuple, list)):
        for t in out:
            yield from _cuda_devices(t)
    elif isinstance(out, torch.Tensor) and out.is_cuda:
        yield out.device


def _synchronize(out) -> None:
    """Wait for every card a result (a tensor, or tuples and lists of
    them: a sharded tile's) lies on."""
    for dev in set(_cuda_devices(out)):
        torch.cuda.synchronize(dev)


def timed_kernel_call(kernel: str, fn, *args, **kw):
    """Run a kernel wrapper and record its wall time, synchronised with the
    card, into vm_tpu_kernel_duration_seconds{kernel, phase}, the flight
    recorder (``device:<phase>``) and the query's cost tracker (as device
    time with no CPU).  The phase is "compile" for a call that had to
    build or load a kernel library first, "execute" otherwise."""
    loads = kernels.loads()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    _synchronize(out)
    dt = time.perf_counter() - t0
    phase = "compile" if kernels.loads() > loads else "execute"
    _kernel_histogram(kernel, phase).update(dt)
    _flightrec.rec(f"device:{phase}", t0, dt, arg=kernel)
    tr = _costacc.current()
    if tr is not None:
        tr.lap(f"device:{phase}", dt, 0.0)
    return out


def _pull(out: torch.Tensor) -> np.ndarray:
    """D2H pull of a kernel result with byte accounting — the one seam
    where device results cross back to the host."""
    nbytes = out.numel() * out.element_size()
    return tile_cache.timed_transfer("device:download", nbytes,
                                     lambda: out.to("cpu").numpy())


def _pull_host(out: torch.Tensor) -> np.ndarray:
    return _pull(out).astype(np.float64, copy=False)


@dataclasses.dataclass
class CUDAEngine:
    """The port's device engine: one card (``device="cuda"``), or the plain
    PyTorch versions when a caller asks for ``device="cpu"``.  With a
    `mesh` (parallel.mesh.Mesh, series axis) tiles are series-sharded over
    its devices and `device` becomes the mesh's first device, where
    results are gathered."""
    device: object = "cuda"
    cache_bytes: int = 2 << 30
    min_series: int = 64         # below this the host path wins
    mesh: object = None          # parallel.mesh.Mesh: series-axis sharding
    last_roll_decline: str = ""  # why the last rolling advance fell back
    _cache: object = None
    _aux: object = None
    _wcache: object = None
    _fleet: object = None

    def __post_init__(self):
        if self.mesh is not None:
            self.device = meshlib.first_device(self.mesh)
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDAEngine: no CUDA device is available "
                               "(pass device='cpu' for the plain versions)")

    def series_shards(self) -> int:
        """Size of the mesh's series axis (1 = single-device engine)."""
        if self.mesh is None:
            return 1
        return self.mesh.shape[AXIS_SERIES]

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

    def fleet(self):
        """Fleet-batched stream plane (query.fleet.FleetPlane): every
        device-resident stream of one bucket shape packed on a leading
        stream axis and served by ONE launch per interval."""
        if self._fleet is None:
            from .fleet import FleetPlane
            self._fleet = FleetPlane(self)
        return self._fleet


def auto_mesh():
    """Series-axis mesh over every visible CUDA device, or None below two
    cards (the reference's rule, query/tpu_engine.py:454-468): one card
    serves unsharded."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        return None
    return meshlib.make_mesh(n_series=n, n_time=1)


@dataclasses.dataclass(frozen=True)
class MeshGroups:
    """A series-sharded tile's group layouts: `full` over the live rows on
    the gather device (the quantile's, B8, over the gathered rollup) and
    one per shard over its row block, padded rows in group 0 (B13's; their
    rollup is NaN and adds nothing)."""
    full: GroupLayout
    shards: tuple

    @property
    def gids(self) -> torch.Tensor:
        return self.full.gids

    @property
    def num_groups(self) -> int:
        return self.full.num_groups


def groups_for(engine: CUDAEngine, gids, num_groups: int):
    """The group layout a query's kernels take: a GroupLayout on the
    engine's device, or MeshGroups on a series-sharded engine."""
    full = group_layout(gids, num_groups, engine.device)
    if engine.series_shards() <= 1:
        return full
    g = np.asarray(gids if not torch.is_tensor(gids) else gids.cpu(),
                   dtype=np.int32)
    blocks = shard_put(engine.mesh, "gids", g, 0)
    return MeshGroups(full, tuple(group_layout(b, num_groups, b.device)
                                  for b in blocks))


def tile_shape(tiles) -> tuple[int, int]:
    """(rows, columns) of a tile, summed over its shards (padded rows
    included)."""
    ts = tiles[0]
    if isinstance(ts, list):
        return sum(int(t.shape[0]) for t in ts), int(ts[0].shape[1])
    return int(ts.shape[0]), int(ts.shape[1])


def rolled_rows(engine: CUDAEngine, func: str, tiles, cfg: RollupConfig,
                min_ts=MIN_TS_NONE, shift: int = 0) -> torch.Tensor:
    """B5 over a tile -> float64 [rows, T] on the engine's device; on a
    series-sharded tile each shard writes its block of one buffer there
    (a peer copy from another card)."""
    ts_t, v_t, counts = tiles
    if not isinstance(ts_t, list):
        return rollup_tile(func, ts_t, v_t, counts, cfg, min_ts, shift)
    out = torch.empty((tile_shape(tiles)[0], num_steps(cfg)),
                      dtype=torch.float64, device=engine.device)
    r0 = 0
    for ts, v, c in zip(ts_t, v_t, counts):
        block = out[r0:r0 + ts.shape[0]]
        here = ts.device == engine.device
        with kernels.on_device(ts.device):
            got = rollup_tile(func, ts, v, c, cfg, min_ts, shift,
                              out=block if here else None)
        if not here:
            block.copy_(got, non_blocking=True)
        r0 += int(ts.shape[0])
    return out


def _fingerprint(series, start_ms: int) -> tuple:
    h = hashlib.blake2b(digest_size=8)
    for sd in series:
        raw = getattr(sd, "raw_name", None)
        h.update(raw if raw is not None else sd.metric_name.marshal())
        h.update(np.int64(sd.timestamps.size).tobytes())
        if sd.timestamps.size:
            h.update(np.int64(sd.timestamps[-1]).tobytes())
    return ("tile", int.from_bytes(h.digest(), "little"), start_ms)


def _span_fits(cfg: RollupConfig) -> bool:
    return cfg.end - cfg.start + cfg.lookback < 2**31 - 1


def _resident_tiles(engine: CUDAEngine, series, cfg: RollupConfig,
                    cache_key):
    """The query's tile from the device cache, uploaded on a miss."""
    key = cache_key or _fingerprint(series, cfg.start)
    cache = engine.cache()
    tiles = cache.get(key)
    if tiles is None:
        tiles = _upload_tiles(engine, series, cfg)
        cache.put_device(key, tiles)
    return tiles


def try_rollup(engine: CUDAEngine, func: str, series, cfg: RollupConfig,
               args: tuple, cache_key=None):
    """Per-series rollup rows on device (B5).  Returns a list of float64
    [T] rows, one per series, or None when the query is not one the
    device runs."""
    if func not in CORE_SUPPORTED:
        return None  # device kernels cover the core set
    if args:
        return None
    if len(series) < engine.min_series:
        return None
    if not _span_fits(cfg):
        return None  # needs chunking; host path handles it
    tiles = _resident_tiles(engine, series, cfg, cache_key)
    out = timed_kernel_call("rollup_tile", rolled_rows, engine, func, tiles,
                            normalized_cfg(func, cfg))
    # mesh tiles are row-padded; only the live rows come back
    return list(_pull_host(out[:len(series)]))


TOPK_RANK_KINDS = frozenset({"max", "min", "avg", "median", "last"})


def try_topk_rollup(engine: CUDAEngine, name: str, k: float, func: str,
                    series, cfg: RollupConfig, cache_key=None):
    """Fused topk/bottomk family on device: the [S, T] rollup stays on the
    card; selection (per-step top-k, B6, or the whole-series rank of the
    topk_<kind> variants, B7) runs there too and only winner indices and
    the k selected rows come back.

    Returns a list of (series index, values row) — the caller attaches
    names — or None when the query is not one the device runs."""
    if func not in CORE_SUPPORTED:
        return None
    if len(series) < engine.min_series:
        return None
    if not _span_fits(cfg):
        return None
    bottom = name.startswith("bottomk")
    if name in ("topk", "bottomk"):
        kind = None
    else:
        kind = name.split("_", 1)[1]
        if kind not in TOPK_RANK_KINDS:
            return None
    k_i = max(int(k), 0)
    if k_i == 0:
        return []
    tiles = _resident_tiles(engine, series, cfg, cache_key)
    dev = engine.device
    # on a mesh, the shards' rollups gathered on the first device
    rolled = timed_kernel_call("rollup_tile", rolled_rows, engine, func,
                               tiles, normalized_cfg(func, cfg))
    if kind is None:
        k_eff = min(k_i, int(rolled.shape[0]))
        idx, sel_nan = timed_kernel_call("topk_select_tile", topk_select,
                                         rolled, k_eff, bottom)
        idx_h = _pull(idx).astype(np.int64)
        valid = ~_pull(sel_nan)
        # padded tile rows roll to all-NaN and are never selected valid
        sel = np.unique(idx_h[valid])
        sel = sel[sel < len(series)]
        if sel.size == 0:
            return []
        rows_sel = _pull_host(timed_kernel_call(
            "take_rows", take_rows, rolled, torch.from_numpy(sel).to(dev)))
        # rebuild the kept-sample mask for the selected rows
        t_pos, j_pos = np.nonzero(valid)
        s_pos = idx_h[t_pos, j_pos]
        keep = s_pos < len(series)
        row_of = np.searchsorted(sel, s_pos[keep])
        mask = np.zeros((sel.size, rows_sel.shape[1]), dtype=bool)
        mask[row_of, t_pos[keep]] = True
        out = []
        for j, i in enumerate(sel):
            vals = np.where(mask[j], rows_sel[j], np.nan)
            if not np.isnan(vals).all():
                out.append((int(i), vals))
        return out
    rank = timed_kernel_call("rank_tile", rank_rows, rolled, kind)
    rank_h = _pull_host(rank)[:len(series)]
    # the host evaluator's ordering: stable sorts, ties favour later series
    rank_h = np.where(np.isnan(rank_h), np.inf if bottom else -np.inf,
                      rank_h)
    if bottom:
        order = np.argsort(-rank_h, kind="stable")
    else:
        order = np.argsort(rank_h, kind="stable")
    sel = order[-min(k_i, len(series)):]  # rank order, ties favour later
    rows_sel = _pull_host(timed_kernel_call(
        "take_rows", take_rows, rolled, torch.from_numpy(sel).to(dev)))
    return [(int(i), rows_sel[j]) for j, i in enumerate(sel)]


def try_aggr_rollup(engine: CUDAEngine, aggr: str, func: str, series,
                    gids, num_groups: int, cfg: RollupConfig,
                    cache_key=None):
    """Fused aggr(rollup(selector)) on device: per-series rollup and
    segment aggregation in one kernel (K2), so only the [G, T] aggregate
    crosses back to the host.  Returns a float64 [G, T] array, or None
    when the query is not one the device runs."""
    if aggr not in FUSED_AGGRS or func not in CORE_SUPPORTED:
        return None
    if len(series) < engine.min_series:
        return None
    if not _span_fits(cfg):
        return None
    tiles = _resident_tiles(engine, series, cfg, cache_key)
    return _dispatch_fused(engine, aggr, func, tiles,
                           groups_for(engine, gids, num_groups), cfg)


def warmup(engine: CUDAEngine, funcs=("rate", "increase", "default_rollup"),
           aggrs=("sum",)) -> int:
    """Build and load the kernels and run the per-series and fused queries
    once on a small canonical shape, so the first real query pays neither.
    Returns the number of queries run.  A kernel that fails to build or
    launch raises."""
    from ..storage.storage import SeriesData
    S, N = max(int(engine.min_series), 64), 128
    start = (fasttime.unix_ms() - N * 15_000) // 60_000 * 60_000
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
        if try_rollup(engine, func, series, cfg, ()) is not None:
            n_runs += 1
        for aggr in aggrs:
            if try_aggr_rollup(engine, aggr, func, series, gids, 1,
                               cfg) is not None:
                n_runs += 1
    return n_runs


def _dispatch_fused(engine: CUDAEngine, aggr: str, func: str, tiles,
                    groups, cfg: RollupConfig, shift: int = 0,
                    min_ts=None) -> np.ndarray:
    """Run K2 on a tile, or B13 on a series-sharded one, and pull the
    [G, T] result.  `shift` rebases rolling-tile timestamps onto the query
    grid and `min_ts` reproduces fetch truncation on over-covering
    tiles."""
    if min_ts is None:
        min_ts = MIN_TS_NONE
    ts_t, v_t, counts = tiles
    ncfg = normalized_cfg(func, cfg)
    if engine.series_shards() > 1:
        fn = meshlib.cached_sharded_rollup_aggregate(
            engine.mesh, func, aggr, ncfg, groups.num_groups)
        out = timed_kernel_call("sharded_rollup_aggregate", fn, ts_t, v_t,
                                counts, groups.shards, int(shift),
                                int(min_ts))
    else:
        out = timed_kernel_call("rollup_aggregate_tile",
                                rollup_aggregate_tile, func, aggr, ts_t, v_t,
                                counts, groups, ncfg, int(shift),
                                int(min_ts))
    return _pull_host(out)


#: series of at most this many samples convert on float_to_decimal's
#: scalar path (repr digits), which the grouped conversion may round a
#: final ulp otherwise for full-precision floats
SCALAR_SAMPLES = 8


def decimal_columns(series):
    """The cold upload's float -> decimal over every series at once:
    (mantissas int64 [total], starts int64 [S], exponents int64 [S]) of
    the series' concatenated values, from one float_to_decimal_grouped
    call (native from 256 samples on).  Series of <= SCALAR_SAMPLES
    samples are then redone on float_to_decimal's scalar path, so every
    series converts exactly as float_to_decimal converts it alone.
    Every series must hold a sample."""
    counts = np.array([sd.values.size for sd in series], dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(counts[:-1])]).astype(np.int64)
    m, exps = dec.float_to_decimal_grouped(
        np.concatenate([sd.values for sd in series]), starts)
    for i in np.flatnonzero(counts <= SCALAR_SAMPLES):
        m[starts[i]:starts[i] + counts[i]], exps[i] = \
            dec.float_to_decimal(series[i].values)
    return m, starts, exps


def pack_columns(series, m, starts, exps, start_ms: int):
    """Delta planes at the tile's capacity (tile_capacity columns, the
    d2 planes zero past each row's data) from decimal_columns' output and
    the series' timestamps; None when the data needs more than int32."""
    n = int(np.diff(np.append(starts, m.size)).max())
    return dd.pack_delta_planes_flat(
        np.concatenate([sd.timestamps for sd in series]), m, starts, exps,
        start_ms, tile_capacity(n) - 2)


def host_planes(series, start_ms: int):
    """The cold upload's host half: one grouped conversion, one flat pack;
    None (a dense tile) for an empty series or out-of-int32 data."""
    if not series or min(sd.timestamps.size for sd in series) < 1:
        return None
    m, starts, exps = decimal_columns(series)
    return pack_columns(series, m, starts, exps, start_ms)


def _upload_tiles(engine: CUDAEngine, series, cfg: RollupConfig):
    """Cold upload: compact delta planes decoded on device (~2-5
    B/sample over the link); dense tiles when the data needs >int32.

    On a mesh the rows are padded to a multiple of the series axis
    (padded rows: count 0 and scale 1, which K1 decodes to TS_PAD rows)
    and placed per the partition rules, and K1 decodes each shard's rows
    on its own device: the decoded tile never leaves it."""
    mesh = engine.mesh if engine.series_shards() > 1 else None

    def put(a, name, pad_value=0):
        return shard_put(mesh, name, a, pad_value, device=engine.device)

    planes = host_planes(series, cfg.start)
    if planes is not None:
        # headroom columns for rolling appends (pack_columns built the d2
        # planes n_cap - 2 wide): zero d2 planes decode into tails that
        # every kernel masks out via counts
        n_cap = tile_capacity(int(planes.counts.max()))
        dev = [put(getattr(planes, f.name), f.name,
                   1 if f.name == "scale" else 0)
               for f in dataclasses.fields(planes)]
        ts_t, v_t = timed_kernel_call(
            "decode_tiles", per_shard,
            lambda *a: dd.decode_tiles(*a, n_cap), *dev)
        return ts_t, v_t, dev[7]
    ts, vals, counts = pack_series(
        [(sd.timestamps, sd.values) for sd in series], cfg.start,
        n_pad=tile_capacity(
            max((sd.timestamps.size for sd in series), default=1)))
    return (put(ts, "ts", int(TS_PAD)), put(vals, "values"),
            put(counts, "counts"))


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
    entry the tile was adopted from, `adopted_key`) is invalidated first.

    `lock` serializes whoever advances or reads the tile and the grids
    rolled on it (the evaluator's rolling shortcut from its advance to
    its RingBlock's commit, the fleet's adoption): two refreshes of one
    window at once would otherwise both append the same slice and both
    shift the ring from the same state."""

    __slots__ = ("tiles", "base_ms", "n_cap", "lo_ms", "hi_ms", "version",
                 "structural", "counts_host", "row_of_raw", "n_samples",
                 "adopted_key", "appends", "segments", "lock")

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
        self.lock = make_rlock("cuda_engine.RollingTile.lock")

    def samples_in_range(self, fetch_lo: int) -> int:
        return sum(n for _, seg_hi, n in self.segments if seg_hi >= fetch_lo)


def device_roll_keys(selector: str, tenant, func: str, aggr: str, phi,
                     grouping, without: bool, max_series, window: int):
    """(roll_state_key, roll_tile_key) of the device-resident rolling
    window that serves aggr(func(selector[window])) by (grouping), or
    (None, None) when the shape cannot roll: the time-valued funcs read
    absolute grids, lifetime the row's first sample, and the adjustable
    windows (and default_rollup) at window <= 0 depend on per-fetch data.
    The keys are the reference's (query/eval.py:_device_roll_keys), with
    the selector's canonical text."""
    if func in TIME_VALUED_FUNCS or func == "lifetime" or \
            (window <= 0 and (func in ADJUSTABLE_WINDOW_FUNCS
                              or func == "default_rollup")):
        return None, None
    return (("roll-aggr", selector, tenant, func, aggr, phi, tuple(grouping),
             without, max_series),
            ("roll-tile", selector, tenant, max_series))


def register_window(engine: CUDAEngine, roll_state_key, roll_tile_key, gids,
                    group_keys, tile_key=None, series=None,
                    cfg: RollupConfig | None = None, fetch_info=None,
                    structural=None, groups=None, qx=None, ring_block=None):
    """File a query shape's device-resident rolling window: the entry the
    rolling refresh and the fleet's adoption read (the reference's
    query/eval.py:1325-1351, which the port's evaluator calls this for).

    The selector's RollingTile lives under `roll_tile_key`.  After a cold
    query (`tile_key` the key of its cached tile, with the query's
    `series`, `cfg`, `fetch_info` = (fetch_lo, end, data version) and the
    storage's `structural` version) a tile not yet adopted from that
    cache entry is wrapped in a new RollingTile; without `tile_key` the
    selector's existing RollingTile is reused.  The shape's entry goes
    under `roll_state_key` as the reference's 5-tuple (rolling tile,
    group layout, group keys, qx, ring block): `groups` is the layout
    (``groups_for(engine, gids, len(group_keys))`` when None), `qx` a
    quantile's (slots tensor, max group) or None, `ring_block` the
    host copy of the [G, T] result (rollup_result_cache.RingBlock) the
    rolling path reuses columns from, or None.  Returns the RollingTile,
    or None when there is none to register (an evicted tile, or series
    without raw names)."""
    wcache = engine.window_cache()
    rt = wcache.get(roll_tile_key)
    if tile_key is not None:
        tiles = engine.cache().get(tile_key)
        if tiles is None or any(sd.raw_name is None for sd in series):
            return None
        if not isinstance(rt, RollingTile) or rt.adopted_key != tile_key:
            rt = RollingTile(
                tiles=tiles, base_ms=cfg.start, n_cap=tile_shape(tiles)[1],
                lo_ms=fetch_info[0], hi_ms=fetch_info[1],
                version=fetch_info[2], structural=structural,
                counts_host=np.fromiter((sd.timestamps.size for sd in series),
                                        np.int64, len(series)),
                row_of_raw={sd.raw_name: i for i, sd in enumerate(series)},
                n_samples=sum(sd.timestamps.size for sd in series),
                adopted_key=tile_key)
            wcache.put(roll_tile_key, rt)
    elif not isinstance(rt, RollingTile):
        return None
    if groups is None:
        groups = groups_for(engine, gids, len(group_keys))
    wcache.put(roll_state_key,
               (rt, groups, list(group_keys), qx, ring_block))
    return rt


def advance_rolling(engine: CUDAEngine, rt: RollingTile, storage, filters,
                    start: int, fetch_lo: int, end: int, max_series, tenant,
                    drop_stale: bool, tracer=None) -> bool:
    """Bring `rt` up to date with storage for a query fetching
    [fetch_lo, end]: fetch only the slice newer than the tile's covered
    range and append it on device.  Returns False when the tile cannot be
    advanced (late/backfilled data, deletes, new series, capacity/int32
    exhausted); the caller then rebuilds through the cold path.  With a
    query `tracer` the slice fetch and the append are its child spans."""
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
        qt = tracer.new_child("slice fetch (%d, %d]", rt.hi_ms, end) \
            if tracer is not None else None
        try:
            cols = storage.search_columns(filters, rt.hi_ms + 1, end,
                                          max_series=max_series,
                                          tenant=tenant)
        except ResourceWarning as e:
            from .limits import QueryLimitError
            raise QueryLimitError(
                f"{e}; either narrow the selector or raise "
                f"-search.maxUniqueTimeseries") from None
        if getattr(storage, "last_partial", False):
            return no("partial slice fetch")
        if drop_stale:
            cols.drop_stale_nans()
        if qt is not None:
            qt.donef("%d series, %d samples", cols.n_series, cols.n_samples)
        if cols.n_series:
            qa = tracer.new_child("device append") if tracer is not None \
                else None
            ok = _append_cols(engine, rt, cols, fetch_lo)
            if qa is not None:
                qa.donef("%d samples -> row tails", cols.n_samples)
            if not ok:
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
    # K4 per shard on a mesh, every shard at the same cutoff
    new_ts, new_vals, new_counts = timed_kernel_call(
        "compact_tile", per_shard,
        lambda ts, v, c: compact_tile(ts, v, c, int(cutoff_rel),
                                      int(cutoff_rel)), *rt.tiles)
    rows = len(rt.counts_host)  # the live rows (a mesh tile pads more)
    counts_host = tile_cache.timed_transfer(
        "device:download", rows * 4,
        lambda: host_rows(new_counts, rows).astype(np.int64))
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
    S_tile = tile_shape(rt.tiles)[0]
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
    # the tile rows are already padded to the mesh multiple: these puts
    # only place the columns per shard
    mesh = engine.mesh if engine.series_shards() > 1 else None
    news = [shard_put(mesh, name, a, device=engine.device) for name, a in
            (("ts", new_ts), ("values", new_vals), ("counts", new_counts))]
    timed_kernel_call("append_tile", per_shard, append_tile, *rt.tiles,
                      *news)
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


# Device-memory budget of the reference's dense [G, M, T] quantile tensor
# (it holds the scatter target and its sorted copy at once).  The port
# builds no dense tensor, but declines exactly the shapes the reference
# declines.
_QUANTILE_DENSE_BYTES = 512 << 20
_VALUE_ITEMSIZE = 8  # float64 tiles


def group_slots(gids, num_groups: int):
    """Per-series slot within its group (ascending series order, the
    order GroupLayout walks) and the largest group size."""
    counts_per_group = np.bincount(gids, minlength=num_groups)
    max_group = int(counts_per_group.max()) if num_groups else 0
    next_slot = np.zeros(num_groups, dtype=np.int32)
    slots = np.empty(len(gids), dtype=np.int32)
    for i, g in enumerate(gids):
        slots[i] = next_slot[g]
        next_slot[g] += 1
    return slots, max_group


def quantile_dense_fits(engine: CUDAEngine, num_groups: int, max_group: int,
                        cfg: RollupConfig) -> bool:
    T = (cfg.end - cfg.start) // cfg.step + 1
    return num_groups * max_group * T <= \
        _QUANTILE_DENSE_BYTES // (_VALUE_ITEMSIZE * 2)


def try_quantile_rollup(engine: CUDAEngine, phi: float, func: str, series,
                        gids, num_groups: int, cfg: RollupConfig,
                        max_group: int, cache_key=None):
    """Fused quantile/median(phi, rollup(selector)) by (...) on device.
    `max_group` comes from group_slots().  Returns a float64 [G, T] array,
    or None when the query is not one the device runs."""
    if func not in CORE_SUPPORTED:
        return None
    if len(series) < engine.min_series:
        return None
    if not _span_fits(cfg):
        return None
    if not quantile_dense_fits(engine, num_groups, max_group, cfg):
        return None  # the reference's dense budget: host wins
    tiles = _resident_tiles(engine, series, cfg, cache_key)
    return run_quantile_on_tiles(
        engine, phi, func, tiles,
        group_layout(gids, num_groups, engine.device), cfg)


def run_quantile_on_tiles(engine: CUDAEngine, phi: float, func: str, tiles,
                          groups, cfg: RollupConfig, shift: int = 0,
                          min_ts=None) -> np.ndarray:
    """Fused quantile over a device-resident tile (the warm and rolling
    path): `shift` rebases rolling-tile timestamps onto the query grid and
    `min_ts` reproduces fetch truncation, as for run_fused_on_tiles.  On a
    mesh B5 runs per shard into one gathered [rows, T] rollup, and B8 runs
    there over the live rows only (the padded rows are dropped before the
    layout, never given out-of-range groups)."""
    if min_ts is None:
        min_ts = MIN_TS_NONE
    layout = groups.full if isinstance(groups, MeshGroups) else groups
    rolled = timed_kernel_call("rollup_tile", rolled_rows, engine, func,
                               tiles, normalized_cfg(func, cfg), int(min_ts),
                               int(shift))
    out = timed_kernel_call("rollup_quantile_tile", quantile_groups,
                            rolled[:layout.gids.shape[0]], layout, float(phi))
    return _pull_host(out)
