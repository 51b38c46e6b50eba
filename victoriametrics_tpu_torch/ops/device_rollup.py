"""Rolling-tile kernels: fused rollup + group aggregate (K2), append (K3)
and window compaction (K4), each beside its plain PyTorch version.

Port of the main-path part of ``victoriametrics_tpu/ops/device_rollup.py``.
A tile is the device-resident state of one selector:

  ts:     int32 [S, N]  sample timestamps, ms, relative to the tile base,
                        padded with TS_PAD past counts
  values: float64 [S, N] (anything past counts; masked via counts)
  counts: int32 [S]     valid samples per row

The fused kernel computes ``aggr(rollup(m[window]))`` -> [G, T] for the
counter rollups ``rate``, ``increase``, ``increase_pure`` and ``irate`` and
the eight ``AGGR_FUNCS``.  Empty windows give NaN, a NaN series value means
"absent at this step", and a group with no live series at a step is NaN.

The kernel wrappers launch ``csrc/*.cu`` for CUDA tensors and run the plain
version for CPU tensors; they never fall back from one to the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import kernels
from .rollup_np import RollupConfig

TS_PAD = np.int32(2**31 - 1)
MIN_TS_NONE = np.int32(-2**31 + 1)
_I32_MIN = -2**31
_I32_MAX = 2**31 - 1

# Funcs whose output embeds absolute time: they read cfg.start and cannot
# run on a start-rebased grid.
TIME_VALUED_FUNCS = frozenset({"tfirst_over_time", "tlast_over_time",
                               "timestamp"})

#: rollup funcs the fused kernel (K2) computes, with their kernel codes
FUSED_FUNCS = {"rate": 0, "increase": 1, "increase_pure": 2, "irate": 3}
#: aggregates, with their kernel codes (the reference's FLEET_AGGR_CODES)
AGGR_FUNCS = {"sum": 0, "count": 1, "avg": 2, "min": 3, "max": 4,
              "stddev": 5, "stdvar": 6, "group": 7}


def normalized_cfg(func: str, cfg: RollupConfig) -> RollupConfig:
    """Rebase the window grid to start=0: tile timestamps are relative to
    cfg.start and the kernel grid is relative, so two queries with the
    same span/step/window run the same launch shape.  Time-valued funcs
    keep the absolute cfg."""
    if func in TIME_VALUED_FUNCS or cfg.start == 0:
        return cfg
    return RollupConfig(start=0, end=cfg.end - cfg.start, step=cfg.step,
                        window=cfg.window)


def num_steps(cfg: RollupConfig) -> int:
    return (cfg.end - cfg.start) // cfg.step + 1


def pack_series(series: list[tuple[np.ndarray, np.ndarray]], start_ms: int,
                n_pad: int | None = None
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side packing: ragged [(ts_ms, values)] -> padded tile arrays
    (ts_rel int32 [S, N], values float64 [S, N], counts int32 [S]).

    Timestamps are re-based to start_ms so they fit int32."""
    S = len(series)
    counts = np.array([len(t) for t, _ in series], dtype=np.int32)
    N = n_pad or (int(counts.max()) if S else 1)
    N = max(N, 1)
    ts = np.full((S, N), TS_PAD, dtype=np.int32)
    vals = np.zeros((S, N), dtype=np.float64)
    for i, (t, v) in enumerate(series):
        c = counts[i]
        rel = np.asarray(t, dtype=np.int64) - start_ms
        if c and (rel.max() >= TS_PAD or rel.min() <= -(2**31)):
            raise ValueError("time range too wide for int32 tile; chunk the query")
        ts[i, :c] = rel.astype(np.int32)
        vals[i, :c] = v
    return ts, vals, counts


# ---------------------------------------------------------------------------
# Plain versions (CPU tests, and the reference chip_smoke.py holds the
# kernels against on the card).
# ---------------------------------------------------------------------------

def _valid_mask(counts: torch.Tensor, n: int) -> torch.Tensor:
    return torch.arange(n, device=counts.device)[None, :] < counts[:, None]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row-wise gather x [S, N] at idx [S, T], idx clipped."""
    return torch.take_along_dim(x, idx.clamp(0, x.shape[1] - 1), dim=1)


def _remove_counter_resets(values: torch.Tensor,
                           valid: torch.Tensor) -> torch.Tensor:
    """Monotonize counters: add back the lost base at each reset (prefix
    sum of the drops; the 8x threshold of rollup.go:921).  Pad positions
    contribute nothing."""
    vm = torch.where(valid, values, 0.0)
    prev = torch.cat([vm[:, :1], vm[:, :-1]], dim=1)
    pair_valid = valid & torch.cat(
        [torch.zeros_like(valid[:, :1]), valid[:, :-1]], dim=1)
    drop = torch.where(pair_valid & (vm < prev),
                       torch.where((prev - vm) * 8 < prev, prev - vm, prev),
                       0.0)
    return values + torch.cumsum(drop, dim=1)


def _max_prev_interval_tile(ts: torch.Tensor, counts: torch.Tensor,
                            cfg: RollupConfig,
                            min_ts=MIN_TS_NONE) -> torch.Tensor:
    """Per-series maxPrevInterval int32 [S]: the 0.6 linear-interpolated
    quantile of the last <= 20 sample intervals, in float32, inflated by
    the rollup.go:899 jitter table.  Instant grids use the step.  Samples
    older than `min_ts` are excluded."""
    S, N = ts.shape
    dev = ts.device
    if cfg.start >= cfg.end:
        return torch.full((S,), cfg.step, dtype=torch.int32, device=dev)
    c = counts.to(torch.int64)
    idx = (c - 21).clamp(min=0)[:, None] + torch.arange(21, device=dev)
    tv = _take(ts, idx).to(torch.int64)
    valid = (idx < c[:, None]) & (tv >= int(min_ts))
    d = (tv[:, 1:] - tv[:, :-1]).to(torch.float32)
    dvalid = valid[:, 1:] & valid[:, :-1]
    n = dvalid.sum(dim=1)
    dsort = torch.sort(torch.where(dvalid, d, torch.inf), dim=1).values
    rank = (0.6 * (n - 1).clamp(min=0).to(torch.float64)).to(torch.float32)
    lo_i = torch.floor(rank).to(torch.int64)
    hi_i = torch.ceil(rank).to(torch.int64)
    v_lo = torch.gather(dsort, 1, lo_i[:, None])[:, 0]
    v_hi = torch.gather(dsort, 1, hi_i[:, None])[:, 0]
    q = v_lo + (rank - lo_i.to(torch.float32)) * (v_hi - v_lo)
    si = torch.where(n >= 1, q, 0.0).to(torch.int32)
    si = torch.where(si > 0, si, cfg.step)
    return torch.where(
        si <= 2_000, si + 4 * si, torch.where(
            si <= 4_000, si + 2 * si, torch.where(
                si <= 8_000, si + si, torch.where(
                    si <= 16_000, si + si // 2, torch.where(
                        si <= 32_000, si + si // 4, si + si // 8)))))


def rollup_tile(func: str, ts: torch.Tensor, values: torch.Tensor,
                counts: torch.Tensor, cfg: RollupConfig,
                min_ts=MIN_TS_NONE) -> torch.Tensor:
    """Plain windowed counter rollup over a tile whose timestamps are
    already on the cfg grid -> float64 [S, T] (NaN = gap).

    Windows by ``torch.searchsorted`` on each row's valid prefix, window
    endpoints by gathers.  `min_ts` gates the sample before a window like
    a fetch that started there (rolling tiles hold more history)."""
    if func not in FUSED_FUNCS:
        raise ValueError(f"unsupported device rollup func {func!r}")
    S, N = ts.shape
    dev = ts.device
    nan = torch.tensor(torch.nan, dtype=torch.float64, device=dev)
    valid = _valid_mask(counts, N)
    sts = torch.where(valid, ts.to(torch.int64), int(TS_PAD)).contiguous()
    T = num_steps(cfg)
    grid = torch.arange(T, dtype=torch.int64, device=dev) * cfg.step
    lo_t = grid - cfg.lookback
    hi = torch.searchsorted(sts, grid.expand(S, T).contiguous(), right=True)
    lo = torch.searchsorted(sts, lo_t.expand(S, T).contiguous(), right=True)
    have = hi > lo
    cv = _remove_counter_resets(values, valid)
    cmax = torch.cummax(cv, dim=1).values  # NaN-propagating
    t_prev_i = torch.where(lo >= 1, _take(sts, lo - 1), _I32_MIN)
    has_prev = (lo >= 1) & (t_prev_i >= int(min_ts))
    c_last = torch.where(hi >= 1, _take(cmax, hi - 1), -torch.inf)
    c_prev = torch.where(lo >= 1, _take(cmax, lo - 1), -torch.inf)
    c_first = torch.full((S, T), torch.inf, dtype=torch.float64, device=dev)
    width = int((hi - lo).max()) if S and T else 0
    for k in range(width):
        idx = lo + k
        c_first = torch.where(idx < hi, torch.minimum(c_first, _take(cv, idx)),
                              c_first)
    two = hi - lo >= 2
    if func in ("increase", "increase_pure"):
        neg0 = torch.tensor(-0.0, dtype=torch.float64, device=dev)
        if func == "increase_pure":
            nb = neg0.expand(S, T)
        else:
            d = torch.where(two, _take(cv, lo + 1) - c_first, 0.0)
            born = (c_first + 0.0).abs() < 10.0 * (d.abs() + 1.0)
            nb = torch.where(born, neg0, c_first)
        base = torch.where(has_prev, c_prev, nb)
        return torch.where(have, c_last - base, nan)
    mpi = _max_prev_interval_tile(ts, counts, cfg, min_ts).to(torch.int64)
    has_gprev = has_prev & (t_prev_i > lo_t[None, :] - mpi[:, None])
    t_last = torch.where(hi >= 1, _take(sts, hi - 1),
                         _I32_MIN).to(torch.float64)
    t_prev = t_prev_i.to(torch.float64)
    ok = have & (has_gprev | two)
    if func == "rate":
        t_first = torch.where(have, _take(sts, lo), _I32_MAX).to(torch.float64)
        rate_base = torch.where(has_gprev, c_prev, c_first)
        dt = torch.where(has_gprev, t_last - t_prev, t_last - t_first) / 1e3
        dv = c_last - rate_base
        return torch.where(ok & (dt > 0), dv / dt, nan)
    c_l2 = torch.where(two, _take(cv, hi - 2), c_prev)
    t_l2 = torch.where(two, _take(sts, hi - 2).to(torch.float64), t_prev)
    dt = (t_last - t_l2) / 1e3
    return torch.where(ok & (dt > 0), (c_last - c_l2) / dt, nan)


def partial_group_moments(aggr: str, rolled: torch.Tensor,
                          group_ids: torch.Tensor, num_groups: int
                          ) -> dict[str, torch.Tensor]:
    """Segment moments for one aggregate: {name: [G, T]} of cnt, s1, s2,
    min, max as the aggregate needs them."""
    if aggr not in AGGR_FUNCS:
        raise ValueError(f"unsupported aggregate {aggr!r}")
    S, T = rolled.shape
    present = ~torch.isnan(rolled)
    zeroed = torch.where(present, rolled, 0.0)
    gid = group_ids.to(torch.int64)

    def seg(x):
        return torch.zeros((num_groups, T), dtype=rolled.dtype,
                           device=rolled.device).index_add_(0, gid, x)

    m = {"cnt": seg(present.to(rolled.dtype))}
    if aggr in ("sum", "avg", "stddev", "stdvar"):
        m["s1"] = seg(zeroed)
    if aggr in ("stddev", "stdvar"):
        m["s2"] = seg(zeroed * zeroed)
    if aggr in ("min", "max"):
        fill = torch.inf if aggr == "min" else -torch.inf
        m[aggr] = torch.full((num_groups, T), fill, dtype=rolled.dtype,
                             device=rolled.device).scatter_reduce_(
            0, gid[:, None].expand(S, T), torch.where(present, rolled, fill),
            "amin" if aggr == "min" else "amax")
    return m


def finalize_group_moments(aggr: str,
                           m: dict[str, torch.Tensor]) -> torch.Tensor:
    """Finalize moments into the [G, T] aggregate; NaN where no series is
    live."""
    cnt = m["cnt"]
    if aggr == "sum":
        out = m["s1"]
    elif aggr == "avg":
        out = m["s1"] / cnt
    elif aggr in ("stddev", "stdvar"):
        mean = m["s1"] / cnt
        var = torch.maximum(m["s2"] / cnt - mean * mean,
                            torch.zeros((), dtype=cnt.dtype, device=cnt.device))
        out = torch.sqrt(var) if aggr == "stddev" else var
    elif aggr == "count":
        out = cnt
    elif aggr in ("min", "max"):
        out = m[aggr]
    elif aggr == "group":
        out = torch.ones_like(cnt)
    else:
        raise ValueError(f"unsupported aggregate {aggr!r}")
    return torch.where(cnt > 0, out, torch.nan)


def aggregate_groups(aggr: str, rolled: torch.Tensor, group_ids: torch.Tensor,
                     num_groups: int) -> torch.Tensor:
    """Aggregate per-series rollup results [S, T] into [G, T] by group id.
    NaN inputs mean 'series absent at this step' and are skipped."""
    return finalize_group_moments(
        aggr, partial_group_moments(aggr, rolled, group_ids, num_groups))


# ---------------------------------------------------------------------------
# K2: fused rollup + group aggregate.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GroupLayout:
    """Group ids of a tile's rows plus the member lists the fused kernel
    walks: group g owns rows order[starts[g]:starts[g+1]], ascending."""
    gids: torch.Tensor     # int32 [S]
    order: torch.Tensor    # int32 [S], rows stably sorted by group id
    starts: torch.Tensor   # int32 [G + 1]
    num_groups: int


def group_layout(gids, num_groups: int, device) -> GroupLayout:
    """Build a GroupLayout from host or device group ids (validated to lie
    in [0, num_groups))."""
    g = torch.as_tensor(np.asarray(gids) if not torch.is_tensor(gids)
                        else gids).to(device=device, dtype=torch.int64)
    if g.dim() != 1:
        raise ValueError("group ids must be one-dimensional")
    if g.numel() and (int(g.min()) < 0 or int(g.max()) >= num_groups):
        raise ValueError(f"group ids outside [0, {num_groups})")
    order = torch.sort(g, stable=True).indices
    starts = torch.zeros(num_groups + 1, dtype=torch.int64, device=g.device)
    starts[1:] = torch.cumsum(torch.bincount(g, minlength=num_groups), 0)
    return GroupLayout(g.to(torch.int32), order.to(torch.int32),
                       starts.to(torch.int32), int(num_groups))


def rollup_aggregate_tile_plain(func: str, aggr: str, ts, values, counts,
                                groups: GroupLayout, cfg: RollupConfig,
                                shift: int = 0,
                                min_ts=MIN_TS_NONE) -> torch.Tensor:
    """Plain PyTorch version of K2: rollup_tile, then aggregate_groups."""
    rolled = rollup_tile(func, ts - int(shift), values, counts, cfg, min_ts)
    return aggregate_groups(aggr, rolled, groups.gids, groups.num_groups)


def rollup_aggregate_tile(func: str, aggr: str, ts: torch.Tensor,
                          values: torch.Tensor, counts: torch.Tensor,
                          groups: GroupLayout, cfg: RollupConfig,
                          shift: int = 0,
                          min_ts=MIN_TS_NONE) -> torch.Tensor:
    """Fused aggr(rollup(m[d])) over one tile -> float64 [G, T].

    `shift` (ms) rebases tile timestamps onto the cfg grid: rolling tiles
    keep timestamps relative to their original base while the query grid
    advances, so shift = query_start - tile_base.  `min_ts` is the query's
    fetch lower bound in the shifted frame.  cfg is the normalized (start
    0) grid."""
    if func not in FUSED_FUNCS:
        raise ValueError(f"unsupported device rollup func {func!r}")
    if aggr not in AGGR_FUNCS:
        raise ValueError(f"unsupported aggregate {aggr!r}")
    dev = kernels.placement(ts, values, counts, groups.gids, groups.order,
                            groups.starts)
    if dev.type == "cpu":
        return rollup_aggregate_tile_plain(func, aggr, ts, values, counts,
                                           groups, cfg, shift, min_ts)
    S, N = ts.shape
    G = groups.num_groups
    T = num_steps(cfg)
    if N < 1:
        raise ValueError("tile needs at least one column")
    kernels.require(ts, "ts", torch.int32, (S, N))
    kernels.require(values, "values", torch.float64, (S, N))
    kernels.require(counts, "counts", torch.int32, (S,))
    kernels.require(groups.order, "order", torch.int32, (S,))
    kernels.require(groups.starts, "starts", torch.int32, (G + 1,))
    h = kernels.lib("rollup")
    mpi = torch.empty((S,), dtype=torch.int32, device=dev)
    slots = torch.empty((S,), dtype=torch.int32, device=dev)
    n_irregular = torch.zeros((1,), dtype=torch.int32, device=dev)
    out = torch.empty((G, T), dtype=torch.float64, device=dev)
    stream = kernels.stream_of(dev)
    kernels.check(h, h.vm_rollup_scan(
        ts.data_ptr(), values.data_ptr(), counts.data_ptr(), S, N,
        int(shift), int(min_ts), cfg.step, int(cfg.start >= cfg.end),
        mpi.data_ptr(), slots.data_ptr(), n_irregular.data_ptr(), stream),
        "rollup_aggregate_tile (row scan)")
    # scratch only for rows with a reset, a NaN or -0.0: on the others the
    # reset-corrected counter and its running maximum are the values
    n = int(n_irregular.item())
    cv = torch.empty((n, N), dtype=torch.float64, device=dev)
    cmax = torch.empty((n, N), dtype=torch.float64, device=dev)
    if n:
        kernels.check(h, h.vm_rollup_prep(
            values.data_ptr(), counts.data_ptr(), slots.data_ptr(), S, N,
            cv.data_ptr(), cmax.data_ptr(), stream),
            "rollup_aggregate_tile (row prep)")
    kernels.check(h, h.vm_rollup_groups(
        ts.data_ptr(), values.data_ptr(), cv.data_ptr(), cmax.data_ptr(),
        slots.data_ptr(), counts.data_ptr(), mpi.data_ptr(),
        groups.order.data_ptr(), groups.starts.data_ptr(), G, N, T,
        int(shift), int(min_ts), cfg.step, cfg.lookback, FUSED_FUNCS[func],
        AGGR_FUNCS[aggr], out.data_ptr(), stream),
        "rollup_aggregate_tile (group pass)")
    kernels.LAUNCHES["rollup_aggregate_tile"] += 1
    return out


# ---------------------------------------------------------------------------
# K3 / K4: rolling-tile maintenance.
# ---------------------------------------------------------------------------

def append_tile_plain(ts, values, counts, new_ts, new_values, new_counts):
    """Plain PyTorch version of K3, in place like the kernel."""
    S, N = ts.shape
    K = new_ts.shape[1]
    k = torch.arange(K, device=ts.device)[None, :]
    pos = counts.to(torch.int64)[:, None] + k
    live = (k < new_counts[:, None]) & (pos < N)
    rows = torch.arange(S, device=ts.device)[:, None].expand(S, K)
    ts[rows[live], pos[live]] = new_ts[live]
    values[rows[live], pos[live]] = new_values[live].to(values.dtype)
    counts += new_counts.to(counts.dtype)
    return ts, values, counts


def append_tile(ts: torch.Tensor, values: torch.Tensor, counts: torch.Tensor,
                new_ts: torch.Tensor, new_values: torch.Tensor,
                new_counts: torch.Tensor):
    """Rolling-tile advance: scatter newer samples onto each row's tail,
    IN PLACE on (ts, values, counts) — the resident tile stays one copy
    while ingest appends (the reference donated these buffers).  New
    samples must be strictly newer than each row's existing ones; positions
    at or past N are dropped.  Returns the same three tensors."""
    dev = kernels.placement(ts, values, counts, new_ts, new_values,
                            new_counts)
    if dev.type == "cpu":
        return append_tile_plain(ts, values, counts, new_ts, new_values,
                                 new_counts)
    S, N = ts.shape
    K = new_ts.shape[1]
    kernels.require(ts, "ts", torch.int32, (S, N))
    kernels.require(values, "values", torch.float64, (S, N))
    kernels.require(counts, "counts", torch.int32, (S,))
    kernels.require(new_ts, "new_ts", torch.int32, (S, K))
    kernels.require(new_values, "new_values", torch.float64, (S, K))
    kernels.require(new_counts, "new_counts", torch.int32, (S,))
    h = kernels.lib("tile")
    kernels.check(h, h.vm_append_tile(
        ts.data_ptr(), values.data_ptr(), counts.data_ptr(),
        new_ts.data_ptr(), new_values.data_ptr(), new_counts.data_ptr(),
        S, N, K, kernels.stream_of(dev)), "append_tile")
    kernels.LAUNCHES["append_tile"] += 1
    return ts, values, counts


def compact_tile_plain(ts, values, counts, cutoff_rel: int, delta: int):
    """Plain PyTorch version of K4: fresh output tensors."""
    S, N = ts.shape
    k = torch.arange(N, device=ts.device)[None, :]
    valid = k < counts[:, None]
    drop = (valid & (ts < int(cutoff_rel))).sum(dim=1).to(torch.int32)
    new_counts = counts - drop
    idx = (drop.to(torch.int64)[:, None] + k).clamp(0, N - 1)
    live = k < new_counts[:, None]
    ts2 = torch.where(live, torch.take_along_dim(ts, idx, 1) - int(delta),
                      int(TS_PAD)).to(torch.int32)
    v2 = torch.where(live, torch.take_along_dim(values, idx, 1), 0.0)
    return ts2, v2, new_counts


def compact_tile(ts: torch.Tensor, values: torch.Tensor, counts: torch.Tensor,
                 cutoff_rel: int, delta: int):
    """Window-slide compaction of a rolling tile: drop each row's samples
    older than `cutoff_rel` (tile-relative ms, exclusive — samples AT the
    cutoff survive), shift the survivors to the row front and rebase their
    timestamps by -`delta`.  Freed tail positions get TS_PAD / 0.0.
    Returns NEW (ts, values, counts); the caller drops the old tensors."""
    dev = kernels.placement(ts, values, counts)
    if dev.type == "cpu":
        return compact_tile_plain(ts, values, counts, cutoff_rel, delta)
    S, N = ts.shape
    kernels.require(ts, "ts", torch.int32, (S, N))
    kernels.require(values, "values", torch.float64, (S, N))
    kernels.require(counts, "counts", torch.int32, (S,))
    ts2 = torch.empty_like(ts)
    v2 = torch.empty_like(values)
    c2 = torch.empty_like(counts)
    h = kernels.lib("tile")
    kernels.check(h, h.vm_compact_tile(
        ts.data_ptr(), values.data_ptr(), counts.data_ptr(), ts2.data_ptr(),
        v2.data_ptr(), c2.data_ptr(), S, N, int(cutoff_rel), int(delta),
        kernels.stream_of(dev)), "compact_tile")
    kernels.LAUNCHES["compact_tile"] += 1
    return ts2, v2, c2
