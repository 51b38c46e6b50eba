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
  (``sharded_rollup_aggregate``): each shard runs K2's group walk over its
  row block and writes the aggregate's moments [M, G, T] into one
  [D, M, G, T] buffer on the first shard's device; the hand-written
  combine kernel (``csrc/mesh.cu``) folds the shards in shard order and
  finalizes, the work the reference's XLA-inserted all-reduce does.
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

import functools

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
    kernel folds them in shard order.  Output: float64 [G, T] on the first
    device."""
    if rollup_func not in dr.FUNC_CODES:
        raise ValueError(f"unsupported device rollup func {rollup_func!r}")
    if aggr not in dr.AGGR_FUNCS:
        raise ValueError(f"unsupported aggregate {aggr!r}")
    devs = shard_devices(mesh, AXIS_SERIES)
    dev0 = first_device(mesh)
    T = dr.num_steps(cfg)
    M = len(dr.MOMENTS[aggr])

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
            with kernels.on_device(dev):
                got = dr.rollup_group_moments(
                    rollup_func, aggr, ts[d], values[d], counts[d],
                    groups[d], cfg, shift, min_ts,
                    out=moments[d] if dev == dev0 else None)
            if dev != dev0:
                moments[d].copy_(got, non_blocking=True)
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


def halo_compact(ts, values, valid, h_ts, h_values, h_valid, shift: int):
    """B15's halo compaction of one (series, time) shard: local columns
    ts int32 / values float64 / valid bool [R, C], and the left
    neighbour's last H columns (None for the first time shard), each
    2-D with unit column stride (views of a wider tile are read through
    their row stride, not copied) -> (ts int32 [R, H + C], values
    float64, counts int32 [R]): the valid samples in time order,
    timestamps minus `shift`, then TS_PAD / 0.0."""
    tensors = [ts, values, valid] + ([] if h_ts is None else
                                     [h_ts, h_values, h_valid])
    dev = kernels.placement(*tensors)
    if dev.type == "cpu":
        return halo_compact_plain(ts, values, valid, h_ts, h_values,
                                  h_valid, shift)
    R, C = ts.shape
    H = 0 if h_ts is None else int(h_ts.shape[1])
    for name, t, dtype, width in (
            ("ts", ts, torch.int32, C), ("values", values, torch.float64, C),
            ("valid", valid, torch.bool, C),
            ("halo ts", h_ts, torch.int32, H),
            ("halo values", h_values, torch.float64, H),
            ("halo valid", h_valid, torch.bool, H)):
        if t is None:
            continue
        if t.dtype != dtype or tuple(t.shape) != (R, width):
            raise ValueError(f"{name}: expected {dtype} [{R}, {width}], got "
                             f"{t.dtype} {tuple(t.shape)}")
        if width and t.stride(1) != 1:
            raise ValueError(f"{name}: columns must be contiguous")

    def ptr(t):
        return (None, 0) if t is None else (t.data_ptr(), t.stride(0))

    ts_out = torch.empty((R, H + C), dtype=torch.int32, device=dev)
    v_out = torch.empty((R, H + C), dtype=torch.float64, device=dev)
    counts = torch.empty((R,), dtype=torch.int32, device=dev)
    h = kernels.lib("mesh")
    kernels.check(h, h.vm_halo_compact(
        *ptr(ts), *ptr(values), *ptr(valid), *ptr(h_ts), *ptr(h_values),
        *ptr(h_valid), R, C, H, int(shift), ts_out.data_ptr(),
        v_out.data_ptr(), counts.data_ptr(), kernels.stream_of(dev)),
        "time_sharded_rollup (halo)")
    kernels.LAUNCHES["time_sharded_rollup"] += 1
    return ts_out, v_out, counts


def add_seconds(out: torch.Tensor, shift: int) -> torch.Tensor:
    """B15's add-back for the time-valued funcs, in place on a 2-D block
    with unit column stride: out += shift / 1e3 (one float64 division, in
    the kernel: torch divides a CUDA tensor by a scalar through its
    reciprocal)."""
    dev = kernels.placement(out)
    if dev.type == "cpu":
        return out.add_(float(shift) / 1e3)
    if out.dtype != torch.float64 or out.dim() != 2 or \
            (out.shape[1] and out.stride(1) != 1):
        raise ValueError("out: float64 [R, T] with contiguous columns")
    h = kernels.lib("mesh")
    kernels.check(h, h.vm_add_seconds(
        out.data_ptr(), out.stride(0), out.shape[0], out.shape[1],
        int(shift), kernels.stream_of(dev)), "time_sharded_rollup (add)")
    return out


def rollup_tile_shifted(func, ts, values, counts, cfg, shift: int,
                        out=None) -> torch.Tensor:
    """rollup_tile on timestamps already rebased by `shift` onto the
    shard's grid slice, with the shift re-added for the time-valued funcs
    (which read absolute time).  B5 runs with shift 0, so the time-valued
    funcs take it too.  `out`: the [S, T] block to write (B5's output row
    stride)."""
    out = dr.rollup_tile(func, ts, values, counts, cfg, out=out)
    if func in _TIME_VALUED:
        add_seconds(out, shift)
    return out


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
    its own contiguous grid slice.  Output: float64 [S, T] on the first
    device.  As in the reference, nothing checks that `halo` covers a
    window or that the grid lines up with the column chunks: the caller's
    data must."""
    return _time_sharded(mesh, rollup_func, cfg, halo, plain=False)


def time_sharded_rollup_plain(mesh: Mesh, rollup_func: str,
                              cfg: RollupConfig, halo: int):
    """Plain version of B15: the same shards through halo_compact_plain,
    rollup_tile_plain and a torch add-back, on any device."""
    return _time_sharded(mesh, rollup_func, cfg, halo, plain=True)


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

    def shard(ts, values, valid, h_ts, h_values, h_valid, shift, block):
        """One shard's rollup, into `block` where it is on this device."""
        if plain:
            ts_c, v_c, counts = halo_compact_plain(
                ts, values, valid, h_ts, h_values, h_valid, shift)
            out = dr.rollup_tile_plain(rollup_func, ts_c, v_c, counts,
                                       local_cfg)
            if rollup_func in _TIME_VALUED:
                out = out + float(shift) / 1e3
            return out
        ts_c, v_c, counts = halo_compact(ts, values, valid, h_ts, h_values,
                                         h_valid, shift)
        return rollup_tile_shifted(rollup_func, ts_c, v_c, counts,
                                   local_cfg, shift, out=block)

    def step(ts, values, valid) -> torch.Tensor:
        rows = [int(ts[i][0].shape[0]) for i in range(n_series)]
        out = torch.empty((sum(rows), T_total), dtype=torch.float64,
                          device=dev0)
        r0 = 0
        for i in range(n_series):
            for j in range(n_time):
                dev = mesh.devices[i, j]
                if ts[i][j].device != dev:
                    raise ValueError(f"shard ({i}, {j}) lies on "
                                     f"{ts[i][j].device}, the mesh puts it "
                                     f"on {dev}")
                H = min(int(halo), int(ts[i][j].shape[1]))
                hal = (None, None, None)
                if j and H:
                    # the left neighbour's tail: a view on this device, a
                    # peer copy from another
                    hal = tuple(x[i][j - 1][:, -H:].to(dev, non_blocking=True)
                                for x in (ts, values, valid))
                block = out[r0:r0 + rows[i], j * t_shard:(j + 1) * t_shard]
                with kernels.on_device(dev):
                    got = shard(ts[i][j], values[i][j], valid[i][j], *hal,
                                j * t_shard * cfg.step,
                                block if dev == dev0 and not plain else None)
                if got is not block:
                    block.copy_(got, non_blocking=True)
            r0 += rows[i]
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
