"""Device-mesh sharding for the query engine: B13, B14 and B15.

Port of ``victoriametrics_tpu/parallel/mesh.py``.  The reference's mesh is
single-controller: one process drives every device of a
``jax.sharding.Mesh``.  So is this one: a :class:`Mesh` is an array of
``torch.device`` with the reference's axis names, and one process launches
each shard's kernels on its shard's device.  A device may repeat in the
list: logical shards on one card, which the tests (``["cpu"] * 8``) and
``chip_smoke.py`` (``[cuda:0] * 8``) use as the reference's tests use
eight forced host devices.  A sharded tensor is a list of per-shard
tensors; data moves between shards with
``Tensor.to(device, non_blocking=True)`` (a peer copy between cards), and
logical shards on one card are views of one buffer, so nothing moves.

Three parallel axes:

- AXIS_SERIES: data-parallel over series.  B13
  (``sharded_rollup_aggregate``): K2's group walk over each shard's row
  block writes the aggregate's moments [M, G, T] into one [D, M, G, T]
  buffer on the first shard's device (one launch for the shards of one
  card); the hand-written combine kernel (``csrc/mesh.cu``) folds the
  shards in shard order and finalizes, the work the reference's
  XLA-inserted all-reduce does.
- AXIS_TIME: sequence-parallel over the sample axis.  B15
  (``time_sharded_rollup``): each device holds a contiguous time slice of
  every series' samples; its halo kernel reads the left neighbour's last
  ``halo`` columns (the reference's ``lax.ppermute`` ring), compacts the
  valid samples in time order and rebases them, and B5 rolls up the
  shard's own output steps.
- AXIS_STREAM: the fleet's leading stream axis.  B14
  (``cached_fleet_rollup_aggregate``): B9 on each shard's contiguous
  slice of streams (rollup windows never cross streams, so no exchange
  and no cross-shard reduction), each shard writing its block of one
  [B, G, T] output.

Every wrapper runs the plain PyTorch version for CPU tensors and the
kernels for CUDA tensors, never one for the other; a mesh that mixes CPU
and CUDA devices is refused.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..ops import device_rollup as dr
from ..ops.rollup_np import RollupConfig
from .partition import AXIS_SERIES, AXIS_STREAM, AXIS_TIME, shard_devices


class Mesh:
    """A named array of devices, as ``jax.sharding.Mesh``: ``devices`` is a
    numpy object array of ``torch.device`` shaped like the axes,
    ``shape[name]`` the size of an axis."""

    def __init__(self, devices, axis_names: tuple):
        devs = np.asarray(devices, dtype=object)
        if devs.ndim != len(axis_names):
            raise ValueError(f"{devs.ndim}-d devices for axes {axis_names}")
        if devs.size == 0:
            raise ValueError("a mesh needs at least one device")
        kinds = {d.type for d in devs.flat}
        if len(kinds) > 1 or not kinds <= {"cpu", "cuda"}:
            raise ValueError(f"a mesh runs on CPU or on CUDA devices, not "
                             f"{sorted(kinds)}")
        self.devices = devs
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devs.shape))
        self._key = (tuple(devs.flat), devs.shape, self.axis_names)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key == other._key

    def __hash__(self) -> int:
        return hash(self._key)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def device_array(devices) -> np.ndarray:
    """A 1-d object array of torch.device (names or devices given)."""
    return np.asarray([torch.device(d) for d in devices], dtype=object)


def default_devices() -> list[torch.device]:
    """Every visible CUDA device."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device is visible; pass the mesh's "
                           "devices (e.g. ['cpu'] * 8)")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_series: int | None = None, n_time: int = 1,
              devices=None) -> Mesh:
    """A (series, time) mesh over `devices` (default: every visible CUDA
    device).  A device may repeat: logical shards on one card."""
    devices = default_devices() if devices is None else list(devices)
    n = len(devices)
    if n_series is None:
        n_series = n // n_time
    if n_series * n_time != n or n == 0:
        raise ValueError(f"mesh {n_series}x{n_time} != {n} devices")
    return Mesh(device_array(devices).reshape(n_series, n_time),
                (AXIS_SERIES, AXIS_TIME))


def make_fleet_mesh(devices=None) -> Mesh:
    """One-axis mesh sharding the fleet's leading stream axis over
    `devices` (default: every visible CUDA device)."""
    devices = default_devices() if devices is None else list(devices)
    return Mesh(device_array(devices), (AXIS_STREAM,))


def first_device(mesh: Mesh) -> torch.device:
    """The device results are gathered on: the mesh's first position."""
    return mesh.devices.flat[0]


# ---------------------------------------------------------------------------
# The combine of B13 (csrc/mesh.cu combine_moments).
# ---------------------------------------------------------------------------

def combine_group_moments_plain(aggr: str,
                                moments: torch.Tensor) -> torch.Tensor:
    """Plain version of B13's combine: fold the D shards' moments
    [D, M, G, T] in shard order (sums add; a minimum or maximum keeps the
    earlier of equal values), then finalize_group_moments."""
    names = dr.MOMENTS[aggr]
    if moments.dim() != 4 or moments.shape[1] != len(names):
        raise ValueError(f"{aggr}: moments must be [D, {len(names)}, G, T]")
    G, T = moments.shape[2:]
    acc = {"cnt": torch.zeros((G, T), dtype=torch.float64,
                              device=moments.device)}
    for k in names[1:]:
        fill = torch.inf if k == "min" else -torch.inf if k == "max" else 0.0
        acc[k] = torch.full((G, T), fill, dtype=torch.float64,
                            device=moments.device)
    for d in range(moments.shape[0]):
        for i, k in enumerate(names):
            p = moments[d, i]
            if k == "min":
                acc[k] = torch.where(p < acc[k], p, acc[k])
            elif k == "max":
                acc[k] = torch.where(p > acc[k], p, acc[k])
            else:
                acc[k] = acc[k] + p
    return dr.finalize_group_moments(aggr, acc)


def combine_group_moments(aggr: str, moments: torch.Tensor) -> torch.Tensor:
    """B13's combine: moments [D, M, G, T] -> float64 [G, T]."""
    if aggr not in dr.AGGR_FUNCS:
        raise ValueError(f"unsupported aggregate {aggr!r}")
    dev = kernels.placement(moments)
    if dev.type == "cpu":
        return combine_group_moments_plain(aggr, moments)
    D, M, G, T = moments.shape
    kernels.require(moments, "moments", torch.float64, (D, M, G, T))
    if M != len(dr.MOMENTS[aggr]):
        raise ValueError(f"{aggr}: {M} moments, expected "
                         f"{len(dr.MOMENTS[aggr])}")
    out = torch.empty((G, T), dtype=torch.float64, device=dev)
    h = kernels.lib("mesh")
    kernels.check(h, h.vm_combine_moments(
        moments.data_ptr(), D, M, G * T, dr.AGGR_FUNCS[aggr], out.data_ptr(),
        kernels.stream_of(dev)), "sharded_rollup_aggregate (combine)")
    kernels.LAUNCHES["sharded_rollup_aggregate"] += 1
    return out


# ---------------------------------------------------------------------------
# B13: the series-sharded fused aggregate.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def cached_sharded_rollup_aggregate(mesh: Mesh, rollup_func: str, aggr: str,
                                    cfg: RollupConfig, num_groups: int):
    """Memoised sharded_rollup_aggregate: the serving engine calls this per
    query."""
    return sharded_rollup_aggregate(mesh, rollup_func, aggr, cfg, num_groups)


def sharded_rollup_aggregate(mesh: Mesh, rollup_func: str, aggr: str,
                             cfg: RollupConfig, num_groups: int):
    """B13: aggr(rollup(...)) series-sharded over the mesh.

    Returns call(ts, values, counts, groups, shift=0, min_ts=MIN_TS_NONE):
    ts, values, counts are per-shard lists (shard i's row block on its
    device, rows padded to the series axis with counts 0) and groups the
    per-shard GroupLayouts of each block's group ids (padded rows in
    group 0: their rollup is NaN and adds nothing).  Each shard's moments
    land in one [D, M, G, T] buffer on the first device; the combine
    kernel folds them in shard order.  Where every shard lies on one
    device (logical shards of a card, at most 16), the shards' row scan
    and group pass are one launch each with one host sync; shards on
    different cards run them per card.  Output: float64 [G, T] on the
    first device."""
    if rollup_func not in dr.FUNC_CODES:
        raise ValueError(f"unsupported device rollup func {rollup_func!r}")
    if aggr not in dr.AGGR_FUNCS:
        raise ValueError(f"unsupported aggregate {aggr!r}")
    devs = shard_devices(mesh, AXIS_SERIES)
    dev0 = first_device(mesh)
    T = dr.num_steps(cfg)
    M = len(dr.MOMENTS[aggr])
    one_device = len(set(devs)) == 1 and len(devs) <= dr.MAX_SHARDS

    def call(ts, values, counts, groups, shift: int = 0,
             min_ts=dr.MIN_TS_NONE) -> torch.Tensor:
        if not len(ts) == len(values) == len(counts) == len(groups) == \
                len(devs):
            raise ValueError(f"{len(devs)} series shards expected")
        moments = torch.empty((len(devs), M, num_groups, T),
                              dtype=torch.float64, device=dev0)
        for d, dev in enumerate(devs):
            kernels.placement(ts[d], values[d], counts[d], groups[d].gids)
            if ts[d].device != dev:
                raise ValueError(f"shard {d} lies on {ts[d].device}, the "
                                 f"mesh puts it on {dev}")
        args = (ts, values, counts, groups)
        if one_device:  # one row scan and one group pass for every shard
            with kernels.on_device(dev0):
                dr.rollup_group_moments(rollup_func, aggr, *args, cfg,
                                        shift, min_ts, out=moments)
        else:
            for d, dev in enumerate(devs):
                with kernels.on_device(dev):
                    got = dr.rollup_group_moments(
                        rollup_func, aggr, *([a[d]] for a in args), cfg,
                        shift, min_ts,
                        out=moments[d:d + 1] if dev == dev0 else None)
                if dev != dev0:
                    moments[d:d + 1].copy_(got, non_blocking=True)
        with kernels.on_device(dev0):
            return combine_group_moments(aggr, moments)

    return call


# ---------------------------------------------------------------------------
# B14: the fleet's rollup, sharded on the stream axis.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def cached_fleet_rollup_aggregate(mesh: Mesh, rollup_func: str,
                                  cfg: RollupConfig, num_groups: int):
    """B14: the fleet kernel for one bucket shape over the stream-sharded
    mesh.  Returns call(ts, values, counts, layouts, aggr, shift, min_ts,
    v0), each a per-shard list of that shard's contiguous slice of the
    bucket's streams ([B/D, S, N] planes, [B/D, S] counts and v0,
    FleetLayouts, [B/D] aggregate codes, shifts and fetch bounds).  B9
    runs on each shard's slice, writing its block of one [B, G, T] output
    on the first device (rows of one buffer: no copy where the shard lies
    there); no cross-shard reduction."""
    if rollup_func not in dr.FLEET_FUNCS:
        raise ValueError(f"{rollup_func!r} does not roll in a fleet bucket")
    devs = shard_devices(mesh, AXIS_STREAM)
    dev0 = first_device(mesh)
    T = dr.num_steps(cfg)

    def call(ts, values, counts, layouts, aggr, shift, min_ts, v0):
        if len(ts) != len(devs):
            raise ValueError(f"{len(devs)} stream shards expected")
        B = sum(int(t.shape[0]) for t in ts)
        out = torch.empty((B, num_groups, T), dtype=torch.float64,
                          device=dev0)
        b0 = 0
        for d, dev in enumerate(devs):
            if ts[d].device != dev:
                raise ValueError(f"shard {d} lies on {ts[d].device}, the "
                                 f"mesh puts it on {dev}")
            b = int(ts[d].shape[0])
            args = (rollup_func, cfg, layouts[d], ts[d], values[d],
                    counts[d], aggr[d], shift[d], min_ts[d], v0[d])
            with kernels.on_device(dev):
                got = dr.fleet_rollup_aggregate_tile(
                    *args, out=out[b0:b0 + b] if dev == dev0 else None)
            if dev != dev0:
                out[b0:b0 + b].copy_(got, non_blocking=True)
            b0 += b
        if out.is_cuda:
            kernels.LAUNCHES["cached_fleet_rollup_aggregate"] += 1
        return out

    return call


# ---------------------------------------------------------------------------
# B15: the time-sharded rollup.
# ---------------------------------------------------------------------------

# Funcs needing whole-series context that chunked time sharding cannot see.
_TIME_SHARD_UNSUPPORTED = frozenset({"lifetime"})

# Funcs returning absolute times: rollup_tile adds cfg.start back, so the
# chunk's grid shift must be re-added on top.
_TIME_VALUED = frozenset({"tfirst_over_time", "tlast_over_time", "timestamp"})


def halo_compact_plain(ts, values, valid, h_ts, h_values, h_valid,
                       shift: int):
    """Plain version of B15's halo compaction, a transcription of the
    reference's shard body (mesh.py:183-193): the halo columns (all
    invalid when h_ts is None: the first time shard) before the local
    ones, the valid samples moved to the front by a stable argsort of the
    invalid flag, then ts - shift.  Returns (ts int32 [R, H + C], values,
    counts int32 [R]); past the counts ts is 2^31 - 1 - shift and values
    0.0, as in the reference (every kernel reads only the counted
    prefix)."""
    if h_ts is None:
        R = ts.shape[0]
        h_ts = torch.zeros((R, 0), dtype=ts.dtype, device=ts.device)
        h_values = torch.zeros((R, 0), dtype=values.dtype, device=ts.device)
        h_valid = torch.zeros((R, 0), dtype=torch.bool, device=ts.device)
    ts_ext = torch.cat([h_ts, ts], dim=1)
    v_ext = torch.cat([h_values, values], dim=1)
    ok_ext = torch.cat([h_valid, valid], dim=1)
    counts = ok_ext.sum(dim=1).to(torch.int32)
    order = torch.argsort((~ok_ext).to(torch.int8), dim=1, stable=True)
    ts_c = torch.take_along_dim(torch.where(ok_ext, ts_ext, int(dr.TS_PAD)),
                                order, dim=1)
    v_c = torch.take_along_dim(torch.where(ok_ext, v_ext, 0.0), order, dim=1)
    ts_c = (ts_c.to(torch.int64) - int(shift) + 2**31) % 2**32 - 2**31
    return ts_c.to(torch.int32), v_c, counts


class TimeShard(NamedTuple):
    """One (series, time) shard of B15 on its card: its own columns ts
    int32 / values float64 / valid bool [R, C], each 2-D with unit column
    stride; `left`, whose last `halo` columns are its halo: the left
    neighbour's three arrays when they lie on this card (the first time
    shard: None, halo 0), else copies of their last `halo` columns from
    another card; its grid shift (ms); and where it writes its [R, T]
    block: rows out_row0 and on, columns out_col0 and on, of the float64
    `out` (unit column stride)."""
    ts: torch.Tensor
    values: torch.Tensor
    valid: torch.Tensor
    left: tuple | None
    halo: int
    shift: int
    out: torch.Tensor
    out_row0: int = 0
    out_col0: int = 0


class HaloRows(NamedTuple):
    """B15's halo pass over the shards of one card, per row of their
    concatenation: `src` 0 for a row read in place (its halo and columns
    one segment of the tile, every sample valid: counts = H + C) and 1
    for a row compacted into `ts` / `values` [rows, N] (raw timestamps,
    `counts` valid samples, anything past them)."""
    ts: torch.Tensor
    values: torch.Tensor
    counts: torch.Tensor
    src: torch.Tensor


_DTYPES = ((torch.int32, 4), (torch.float64, 8), (torch.bool, 1))


def _halo_desc(shards, dev) -> list[int]:
    """csrc/mesh.cu vm_halo_compact's kHaloFields values per shard, each
    tensor checked before its pointer crosses into C: a shard reads its
    all-valid rows in place where every array's halo (`left`'s last H
    columns) ends where its own columns start, at the same row stride."""
    desc = []
    C = int(shards[0].ts.shape[1])
    index = -1 if dev.type == "cpu" else dev.index
    for sh in shards:
        R, H = int(sh.ts.shape[0]), sh.halo
        local, halo, inplace = [], [0] * 6, 1
        for k, (dtype, size) in enumerate(_DTYPES):
            t = sh[k]
            st = t.stride()
            if t.dtype is not dtype or t.get_device() != index or \
                    t.shape != (R, C) or (C > 1 and st[1] != 1):
                raise ValueError(f"time shard: {dtype} [{R}, {C}] with "
                                 f"unit column stride on {dev} expected, "
                                 f"got {t.dtype} {tuple(t.shape)} on "
                                 f"{t.device}")
            ptr = t.data_ptr()
            local += [ptr, st[0]]
            if not H:
                continue
            x = sh.left[k]
            xs, w = x.stride(), int(x.shape[-1])
            if x.dtype is not dtype or x.get_device() != index or \
                    x.shape != (R, w) or w < H or (w > 1 and xs[1] != 1):
                raise ValueError(f"halo: {dtype} [{R}, >= {H}] on {dev} "
                                 f"expected, got {x.dtype} "
                                 f"{tuple(x.shape)} on {x.device}")
            end = x.data_ptr() + w * size
            halo[2 * k:2 * k + 2] = [end - H * size, xs[0]]
            inplace &= int(end == ptr and xs[0] == st[0])
        desc += local + halo + [R, H, inplace]
    return desc


def _shard_desc(shards, T: int) -> list[int]:
    """csrc/rollup.cu make_shards' kShardFields values per shard: a row
    read in place starts H columns before the shard's own (the halo's
    first column, in the same tile row).  The shard's tensors are
    _halo_desc's to check."""
    desc = []
    index = shards[0].ts.get_device()
    for sh in shards:
        R, C = sh.ts.shape
        o = sh.out
        os_ = o.stride()
        if o.dtype is not torch.float64 or o.get_device() != index or \
                o.dim() != 2 or \
                o.shape[0] < sh.out_row0 + R or \
                o.shape[1] < sh.out_col0 + T or (T > 1 and os_[1] != 1):
            raise ValueError(f"out: float64 on the shard's device with "
                             f"room for [{R}, {T}] at ({sh.out_row0}, "
                             f"{sh.out_col0}) expected")
        desc += [sh.ts.data_ptr() - 4 * sh.halo, sh.ts.stride(0),
                 sh.values.data_ptr() - 8 * sh.halo, sh.values.stride(0),
                 sh.halo + C, R, int(sh.shift),
                 o.data_ptr() + 8 * (sh.out_row0 * os_[0] + sh.out_col0),
                 os_[0]]
    return desc


def halo_rows(shards) -> HaloRows:
    """B15's halo pass (csrc/mesh.cu halo_compact) over the time shards of
    one card (TimeShards, at most dr.MAX_SHARDS, all of C columns): one
    launch."""
    dev = shards[0].ts.device
    desc = _halo_desc(shards, dev)
    C = int(shards[0].ts.shape[1])
    N = max(sh.halo for sh in shards) + C
    R = sum(int(sh.ts.shape[0]) for sh in shards)
    rows = torch.empty((2, R), dtype=torch.int32, device=dev)
    out = HaloRows(torch.empty((R, N), dtype=torch.int32, device=dev),
                   torch.empty((R, N), dtype=torch.float64, device=dev),
                   rows[0], rows[1])
    h = kernels.lib("mesh")
    kernels.check(h, h.vm_halo_compact(
        len(shards), dr._c_array(ctypes.c_longlong, desc), C, N,
        out.ts.data_ptr(), out.values.data_ptr(), out.counts.data_ptr(),
        out.src.data_ptr(), kernels.stream_of(dev)),
        "time_sharded_rollup (halo)")
    return out


def rollup_time_shards(func: str, cfg: RollupConfig, shards) -> None:
    """B15's kernels over the time shards of one card (TimeShards, at most
    dr.MAX_SHARDS, all on one CUDA device, of C columns each): the halo
    pass, then the row scan, the scratch pass (counter funcs with an
    irregular row) and B5's series pass over every shard at once, one
    launch each, with one host sync (the counter funcs' irregular rows);
    each shard's [R, T] block written in place.  `cfg` is the shard's
    local grid."""
    if not 1 <= len(shards) <= dr.MAX_SHARDS:
        raise ValueError(f"1 to {dr.MAX_SHARDS} shards a launch")
    T = dr.num_steps(cfg)
    desc = dr._c_array(ctypes.c_longlong, _shard_desc(shards, T))
    hr = halo_rows(shards)
    dev = hr.ts.device
    R, N = hr.ts.shape
    D = len(shards)
    rows = (hr.ts.data_ptr(), hr.values.data_ptr(), hr.counts.data_ptr(),
            hr.src.data_ptr())
    h = kernels.lib("rollup")
    stream = kernels.stream_of(dev)
    counter = func in dr.COUNTER_FUNCS
    # mpi, slots, then the irregular rows' count (zeroed by the scan)
    ints = torch.empty((2 * R + 1,), dtype=torch.int32, device=dev)
    mpi, slots, n_irregular = (ints.data_ptr() + 4 * k * R for k in range(3))
    mean = torch.empty((R,), dtype=torch.float64, device=dev) \
        if func in dr.CENTRED_FUNCS else None
    kernels.check(h, h.vm_time_shards_scan(
        D, desc, *rows, N, int(dr.MIN_TS_NONE), cfg.step,
        int(cfg.start >= cfg.end), int(counter), mpi, slots, n_irregular,
        dr._ptr(mean), stream), "time_sharded_rollup (row scan)")
    n = int(ints[2 * R].item()) if counter else 0  # vmt: disable=VMT006 — the count sizes the scratch
    cvm = torch.empty((2, n, N), dtype=torch.float64, device=dev)
    if n:
        kernels.check(h, h.vm_time_shards_prep(
            D, desc, *rows, N, slots, cvm[0].data_ptr(), cvm[1].data_ptr(),
            stream), "time_sharded_rollup (row prep)")
    plan = dr.b5_plan(R, N, T, cfg.step, cfg.lookback,
                      dr.scrape_hint(N, T, cfg.step, cfg.lookback),
                      kernels.sm_count(dev))
    kernels.check(h, h.vm_time_shards_series(
        D, desc, *rows, N, cvm.data_ptr(), cvm.data_ptr() + 8 * n * N,
        slots, mpi, dr._ptr(mean), T, int(dr.MIN_TS_NONE), cfg.step,
        cfg.lookback, float(cfg.start) / 1e3, dr.FUNC_CODES[func],
        int(plan.path == dr.K2_STAGED), plan.rows, plan.steps, plan.cap,
        stream), "time_sharded_rollup (series pass)")
    kernels.LAUNCHES["time_sharded_rollup"] += 1


def time_sharded_rollup(mesh: Mesh, rollup_func: str, cfg: RollupConfig,
                        halo: int):
    """B15: sequence-parallel rollup, the sample axis sharded over
    AXIS_TIME.

    Returns step(ts, values, valid): each a nested list [n_series][n_time]
    of shards (shard (i, j) on device mesh.devices[i, j]: rows block i,
    sample columns block j of equal width; ``split_2d`` makes one from a
    whole tensor).  Shard (i, j) reads the last `halo` columns of shard
    (i, j - 1) (the reference's ring; the first time shard's halo is
    masked), compacts its valid samples and rolls up the output steps of
    its own contiguous grid slice.  The shards of one card run as one
    launch per phase (rollup_time_shards: up to dr.MAX_SHARDS a launch);
    a card's shards write their blocks of the output where it lies there,
    else blocks that are copied to it.  Output: float64 [S, T] on the
    first device.  As in the reference, nothing checks that `halo` covers
    a window or that the grid lines up with the column chunks: the
    caller's data must."""
    return _time_sharded(mesh, rollup_func, cfg, halo, plain=False)


def time_sharded_rollup_plain(mesh: Mesh, rollup_func: str,
                              cfg: RollupConfig, halo: int):
    """Plain version of B15: each shard through halo_compact_plain,
    rollup_tile_plain and a torch add-back, on any device."""
    return _time_sharded(mesh, rollup_func, cfg, halo, plain=True)


def time_shard_batches(mesh: Mesh) -> list[tuple[torch.device, list]]:
    """How B15 launches over `mesh`: per device, in the order devices
    first appear, the (series, time) positions of its shards in
    row-major order, cut into batches of at most dr.MAX_SHARDS; one
    batch is one launch per phase."""
    cards: dict = {}
    n_s, n_t = mesh.shape[AXIS_SERIES], mesh.shape[AXIS_TIME]
    for i in range(n_s):
        for j in range(n_t):
            cards.setdefault(mesh.devices[i, j], []).append((i, j))
    return [(dev, pos[k:k + dr.MAX_SHARDS]) for dev, pos in cards.items()
            for k in range(0, len(pos), dr.MAX_SHARDS)]


def _time_sharded(mesh: Mesh, rollup_func: str, cfg: RollupConfig,
                  halo: int, plain: bool):
    if rollup_func in _TIME_SHARD_UNSUPPORTED:
        raise ValueError(
            f"{rollup_func} needs whole-series context (first sample) and "
            "cannot run on the time-sharded path; use series sharding")
    n_series = mesh.shape[AXIS_SERIES]
    n_time = mesh.shape[AXIS_TIME]
    T_total = (cfg.end - cfg.start) // cfg.step + 1
    if T_total % n_time:
        raise ValueError(f"T={T_total} not divisible by time axis {n_time}")
    t_shard = T_total // n_time
    local_cfg = RollupConfig(start=cfg.start,
                             end=cfg.start + (t_shard - 1) * cfg.step,
                             step=cfg.step, window=cfg.window)
    dev0 = first_device(mesh)
    plain = plain or dev0.type == "cpu"

    def shard_plain(ts, values, valid, hal, shift):
        ts_c, v_c, counts = halo_compact_plain(ts, values, valid, *hal,
                                               shift)
        out = dr.rollup_tile_plain(rollup_func, ts_c, v_c, counts,
                                   local_cfg)
        if rollup_func in _TIME_VALUED:
            out = out + float(shift) / 1e3
        return out

    def step(ts, values, valid) -> torch.Tensor:
        rows = [int(ts[i][0].shape[0]) for i in range(n_series)]
        r0 = np.cumsum([0] + rows)
        out = torch.empty((int(r0[-1]), T_total), dtype=torch.float64,
                          device=dev0)
        for i in range(n_series):
            for j in range(n_time):
                if ts[i][j].device != mesh.devices[i, j]:
                    raise ValueError(f"shard ({i}, {j}) lies on "
                                     f"{ts[i][j].device}, the mesh puts it "
                                     f"on {mesh.devices[i, j]}")

        def shard(i, j, dev):
            """Shard (i, j)'s halo source and width (its left
            neighbour's arrays on this device, copies of their tail from
            another; none for the first time shard) and shift."""
            H = min(int(halo), int(ts[i][j].shape[1])) if j else 0
            left = None
            if H:
                left = tuple(x[i][j - 1] for x in (ts, values, valid))
                if left[0].device != dev:  # a peer copy of the tail
                    left = tuple(x[:, -H:].to(dev, non_blocking=True)
                                 for x in left)
            return left, H, j * t_shard * cfg.step

        for dev, batch in time_shard_batches(mesh):
            shards = []
            for i, j in batch:
                left, H, shift = shard(i, j, dev)
                if plain:
                    hal = (None, None, None) if left is None else \
                        tuple(x[:, -H:] for x in left)
                    out[int(r0[i]):int(r0[i + 1]),
                        j * t_shard:(j + 1) * t_shard] = shard_plain(
                        ts[i][j], values[i][j], valid[i][j], hal, shift)
                    continue
                at = (out, int(r0[i]), j * t_shard) if dev == dev0 else \
                    (torch.empty((rows[i], t_shard), dtype=torch.float64,
                                 device=dev), 0, 0)
                shards.append(TimeShard(ts[i][j], values[i][j], valid[i][j],
                                        left, H, shift, *at))
            if not shards:
                continue
            with kernels.on_device(dev):
                rollup_time_shards(rollup_func, local_cfg, shards)
            for (i, j), sh in zip(batch, shards):
                if sh.out is not out:
                    out[int(r0[i]):int(r0[i + 1]),
                        j * t_shard:(j + 1) * t_shard].copy_(
                        sh.out, non_blocking=True)
        return out

    return step


def split_2d(mesh: Mesh, a: torch.Tensor) -> list[list[torch.Tensor]]:
    """A whole [S, N] tensor as the nested [n_series][n_time] shards of
    time_sharded_rollup: block views where the shard's device is `a`'s,
    else copies on the shard's device.  S and N must divide by the axes."""
    n_s, n_t = mesh.shape[AXIS_SERIES], mesh.shape[AXIS_TIME]
    S, N = a.shape
    if S % n_s or N % n_t:
        raise ValueError(f"[{S}, {N}] does not split over {n_s}x{n_t}")
    r, c = S // n_s, N // n_t
    return [[a[i * r:(i + 1) * r, j * c:(j + 1) * c].to(
        mesh.devices[i, j], non_blocking=True) for j in range(n_t)]
        for i in range(n_s)]
