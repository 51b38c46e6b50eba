"""Rolling-tile kernels, each beside its plain PyTorch version: the
windowed rollup (B5), the fused rollup + group aggregate (K2), append (K3),
window compaction (K4), the selections over a rolled tile: per-step
topk/bottomk and the row gather (B6), the per-series rank statistic (B7)
and the per-group quantile (B8), and the fleet's passes over a [B, S, N]
stack of stream tiles: rollup + aggregate (B9), append (B10) and
compaction (B11).

Port of ``victoriametrics_tpu/ops/device_rollup.py``.  A tile is the
device-resident state of one selector:

  ts:     int32 [S, N]  sample timestamps, ms, relative to the tile base,
                        padded with TS_PAD past counts
  values: float64 [S, N] (anything past counts; masked via counts)
  counts: int32 [S]     valid samples per row

The rollup covers every func of ``CORE_SUPPORTED`` and K2 all eight
``AGGR_FUNCS`` over them.  Empty windows give NaN, a NaN series value
means "absent at this step", and a group with no live series at a step is
NaN.

The kernel wrappers launch ``csrc/*.cu`` for CUDA tensors and run the plain
version for CPU tensors; they never fall back from one to the other.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

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

#: rollup funcs of the rollup kernels (B5, K2), with their kernel codes:
#: every func of CORE_SUPPORTED
FUNC_CODES = {
    "rate": 0, "increase": 1, "increase_pure": 2, "irate": 3,
    "count_over_time": 4, "present_over_time": 5, "sum_over_time": 6,
    "avg_over_time": 7, "stddev_over_time": 8, "stdvar_over_time": 9,
    "min_over_time": 10, "max_over_time": 11, "tfirst_over_time": 12,
    "tlast_over_time": 13, "timestamp": 14, "lag": 15,
    "first_over_time": 16, "last_over_time": 17, "default_rollup": 18,
    "changes": 19, "delta": 20, "idelta": 21, "deriv_fast": 22, "deriv": 23,
    "lifetime": 24, "scrape_interval": 25,
}
#: funcs that read the reset-corrected counter
COUNTER_FUNCS = frozenset({"rate", "increase", "increase_pure", "irate"})
#: funcs centred by the row mean
CENTRED_FUNCS = frozenset({"stddev_over_time", "stdvar_over_time"})
#: rank statistics of topk_<kind>, with their kernel codes
RANK_KINDS = {"max": 0, "min": 1, "avg": 2, "median": 3, "last": 4}
#: aggregates, with their kernel codes
AGGR_FUNCS = {"sum": 0, "count": 1, "avg": 2, "min": 3, "max": 4,
              "stddev": 5, "stdvar": 6, "group": 7}
#: the fleet's per-stream aggregate codes: the same table
FLEET_AGGR_CODES = AGGR_FUNCS
_AGGR_NAMES = {code: name for name, code in AGGR_FUNCS.items()}
#: funcs a fleet bucket rolls (B9): the rolling funcs, not the ones that
#: read absolute time or the row's first sample
FLEET_FUNCS = frozenset(FUNC_CODES) - TIME_VALUED_FUNCS - {"lifetime"}


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


def _serial_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Prefix sum along dim 1 in ascending order, one add after another:
    the order of the kernels and of the reference on the CPU.  torch's CUDA
    scan associates differently, so a CUDA tensor is summed on the CPU."""
    if x.device.type == "cpu":
        return torch.cumsum(x, dim=1)
    return torch.cumsum(x.cpu(), dim=1).to(x.device)


def _remove_counter_resets(values: torch.Tensor, valid: torch.Tensor,
                           v0=None) -> torch.Tensor:
    """Monotonize counters: add back the lost base at each reset (prefix
    sum of the drops; the 8x threshold of rollup.go:921).  Pad positions
    contribute nothing.  `v0` ([S], the fleet's rebase offsets) makes the
    threshold and the restarted base absolute, as in the reference."""
    vm = torch.where(valid, values, 0.0)
    prev = torch.cat([vm[:, :1], vm[:, :-1]], dim=1)
    pair_valid = valid & torch.cat(
        [torch.zeros_like(valid[:, :1]), valid[:, :-1]], dim=1)
    prev_abs = prev if v0 is None else prev + v0[:, None]
    drop = torch.where(pair_valid & (vm < prev),
                       torch.where((prev - vm) * 8 < prev_abs, prev - vm,
                                   prev_abs),
                       0.0)
    return values + _serial_cumsum(drop)


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


def _window_fold(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                 width: int, init: float, op) -> torch.Tensor:
    """Fold `op` over each window's samples x[lo:hi] in ascending sample
    order (the kernels' order), starting from `init`."""
    acc = torch.full(lo.shape, init, dtype=x.dtype, device=x.device)
    for k in range(width):
        idx = lo + k
        acc = torch.where(idx < hi, op(acc, _take(x, idx)), acc)
    return acc


def rollup_tile_plain(func: str, ts: torch.Tensor, values: torch.Tensor,
                      counts: torch.Tensor, cfg: RollupConfig,
                      min_ts=MIN_TS_NONE, v0=None) -> torch.Tensor:
    """Plain windowed rollup of every CORE_SUPPORTED func over a tile whose
    timestamps are already on the cfg grid -> float64 [S, T] (NaN = gap).

    Windows by ``torch.searchsorted`` on each row's valid prefix, window
    endpoints by gathers, window sums and extrema folded in ascending
    sample order.  `min_ts` gates the sample before a window like a fetch
    that started there (rolling tiles hold more history).  `v0` ([S]
    float64, the fleet's rebase offsets) enters where the reference adds
    it: the counter-reset threshold and the new-series base of delta and
    increase; None is the reference's v0=None (x + 0.0, a base of -0.0)."""
    if func not in FUNC_CODES:
        raise ValueError(f"unsupported device rollup func {func!r}")
    S, N = ts.shape
    dev = ts.device
    f64 = torch.float64
    nan = torch.tensor(torch.nan, dtype=f64, device=dev)
    valid = _valid_mask(counts, N)
    sts = torch.where(valid, ts.to(torch.int64), int(TS_PAD)).contiguous()
    T = num_steps(cfg)
    grid = torch.arange(T, dtype=torch.int64, device=dev) * cfg.step
    lo_t = grid - cfg.lookback
    hi = torch.searchsorted(sts, grid.expand(S, T).contiguous(), right=True)
    lo = torch.searchsorted(sts, lo_t.expand(S, T).contiguous(), right=True)
    have = hi > lo
    n = hi - lo
    nw = n.to(f64)
    two = n >= 2
    width = int(n.max()) if S and T else 0
    t_prev_i = torch.where(lo >= 1, _take(sts, lo - 1), _I32_MIN)
    has_prev = (lo >= 1) & (t_prev_i >= int(min_ts))
    t_last = _take(sts, hi - 1).to(f64)
    t_first = _take(sts, lo).to(f64)
    t_prev = t_prev_i.to(f64)

    def fold(x, init, op):
        return _window_fold(x, lo, hi, width, init, op)

    def gated_prev():
        mpi = _max_prev_interval_tile(ts, counts, cfg, min_ts).to(torch.int64)
        return has_prev & (t_prev_i > lo_t[None, :] - mpi[:, None])

    def out(x, ok=None):
        return torch.where(have if ok is None else have & ok, x, nan)

    v = values
    # the reference's v0c: a +0.0 scalar without rebase offsets
    v0c = torch.zeros((), dtype=f64, device=dev) if v0 is None else \
        v0[:, None]
    if func == "count_over_time":
        return out(nw)
    if func == "present_over_time":
        return out(torch.ones_like(nw))
    if func in ("sum_over_time", "avg_over_time"):
        s = fold(v, 0.0, torch.add)
        return out(s if func == "sum_over_time" else s / nw)
    if func in ("stddev_over_time", "stdvar_over_time"):
        total = torch.where(valid, v, 0.0).sum(dim=1, keepdim=True)
        mean = total / counts[:, None].clamp(min=1).to(f64)
        x = v - mean
        s1 = fold(x, 0.0, torch.add)
        s2 = fold(x * x, 0.0, torch.add)
        m1 = s1 / nw
        var = torch.maximum(s2 / nw - m1 * m1,
                            torch.zeros((), dtype=f64, device=dev))
        return out(torch.sqrt(var) if func == "stddev_over_time" else var)
    if func == "min_over_time":
        return out(fold(v, torch.inf, torch.minimum))
    if func == "max_over_time":
        return out(fold(v, -torch.inf, torch.maximum))
    base_s = float(cfg.start) / 1e3
    if func == "tfirst_over_time":
        return out(t_first / 1e3 + base_s)
    if func in ("tlast_over_time", "timestamp"):
        return out(t_last / 1e3 + base_s)
    if func == "lag":
        return out((grid.to(f64)[None, :] - t_last) / 1e3)
    if func == "first_over_time":
        return out(_take(v, lo))
    if func in ("last_over_time", "default_rollup"):
        return out(_take(v, hi - 1))
    if func == "changes":
        vm = torch.where(valid, v, 0.0)
        chg = torch.zeros_like(vm)
        chg[:, 1:] = (valid[:, 1:] & valid[:, :-1] &
                      (vm[:, 1:] != vm[:, :-1])).to(f64)
        s = fold(chg, 0.0, torch.add)
        return out(s - torch.where(has_prev, 0.0, _take(chg, lo)))
    if func == "delta":
        v_first = _take(v, lo)
        d = torch.where(two, _take(v, lo + 1) - v_first, 0.0)
        born = (v_first + v0c).abs() < 10.0 * (d.abs() + 1.0)
        base = torch.where(has_prev, _take(v, lo - 1),
                           torch.where(born, -v0c, v_first))
        return out(_take(v, hi - 1) - base)
    if func == "idelta":
        has_gprev = gated_prev()
        prev = torch.where(two, _take(v, hi - 2), _take(v, lo - 1))
        return out(_take(v, hi - 1) - prev, two | has_gprev)
    if func == "deriv_fast":
        has_gprev = gated_prev()
        base_v = torch.where(has_gprev, _take(v, lo - 1), _take(v, lo))
        base_t = torch.where(has_gprev, t_prev, t_first)
        dt = (t_last - base_t) / 1e3
        return out((_take(v, hi - 1) - base_v) / dt,
                   (has_gprev | two) & (dt > 0))
    if func == "deriv":
        ts_s = sts.to(f64) / 1e3
        st = fold(ts_s, 0.0, torch.add)
        stt = fold(ts_s * ts_s, 0.0, torch.add)
        sv = fold(v, 0.0, torch.add)
        stv = fold(ts_s * v, 0.0, torch.add)
        t0 = t_first / 1e3
        st_ = st - nw * t0
        stt_ = stt - 2 * t0 * st + nw * t0 * t0
        stv_ = stv - t0 * sv
        den = nw * stt_ - st_ * st_
        return out((nw * stv_ - st_ * sv) / den, two & (den != 0))
    if func == "lifetime":
        tf = torch.where(has_prev, sts[:, :1].to(f64), t_first)
        return out((t_last - tf) / 1e3)
    if func == "scrape_interval":
        dt = torch.where(has_prev, t_last - t_prev, t_last - t_first) / 1e3
        cnt = torch.where(has_prev, n, n - 1)
        return out(dt / cnt.to(f64), (has_prev | two) & (cnt > 0))
    # the counter funcs
    cv = _remove_counter_resets(values, valid, v0)
    cmax = torch.cummax(cv, dim=1).values  # NaN-propagating
    c_last = _take(cmax, hi - 1)
    c_prev = torch.where(lo >= 1, _take(cmax, lo - 1), -torch.inf)
    c_first = fold(cv, torch.inf, torch.minimum)
    if func in ("increase", "increase_pure"):
        if func == "increase_pure":
            nb = (-v0c).expand(S, T)
        else:
            d = torch.where(two, _take(cv, lo + 1) - c_first, 0.0)
            born = (c_first + v0c).abs() < 10.0 * (d.abs() + 1.0)
            nb = torch.where(born, -v0c, c_first)
        return out(c_last - torch.where(has_prev, c_prev, nb))
    has_gprev = gated_prev()
    if func == "rate":
        rate_base = torch.where(has_gprev, c_prev, c_first)
        dt = torch.where(has_gprev, t_last - t_prev, t_last - t_first) / 1e3
        return out((c_last - rate_base) / dt, (has_gprev | two) & (dt > 0))
    c_l2 = torch.where(two, _take(cv, hi - 2), c_prev)
    t_l2 = torch.where(two, _take(sts, hi - 2).to(f64), t_prev)
    dt = (t_last - t_l2) / 1e3
    return out((c_last - c_l2) / dt, (has_gprev | two) & (dt > 0))


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


#: the moments each aggregate keeps, in their stored order
#: (csrc/moments.cuh): cnt, then s1 (and s2), or min, or max
MOMENTS = {"sum": ("cnt", "s1"), "avg": ("cnt", "s1"), "min": ("cnt", "min"),
           "max": ("cnt", "max"), "stddev": ("cnt", "s1", "s2"),
           "stdvar": ("cnt", "s1", "s2"), "count": ("cnt",),
           "group": ("cnt",)}


def aggregate_groups(aggr: str, rolled: torch.Tensor, group_ids: torch.Tensor,
                     num_groups: int) -> torch.Tensor:
    """Aggregate per-series rollup results [S, T] into [G, T] by group id.
    NaN inputs mean 'series absent at this step' and are skipped."""
    return finalize_group_moments(
        aggr, partial_group_moments(aggr, rolled, group_ids, num_groups))


# ---------------------------------------------------------------------------
# K2 and B5: the rollup kernels.
# ---------------------------------------------------------------------------

#: The chunk R of K2, B9 and B13's per-shard pass: a group of more members
#: is walked in chunks of R consecutive members, one block each, whose
#: moments fold in chunk order; a one-group bucket of 8192 rows a stream
#: then runs 128 blocks a stream and step tile where it ran one.  A smaller
#: R gives more blocks and a longer serial fold (tools/select_timing.py
#: sweeps R for B9).  Layouts read it when they are built.
FLEET_CHUNK = 64


@dataclasses.dataclass(frozen=True)
class GroupLayout:
    """Group ids of a tile's rows plus the member lists the group kernels
    walk: group g owns rows order[starts[g]:starts[g+1]], ascending.  K2
    and B13 walk a group of more than `chunk` members in chunks of `chunk`
    consecutive members, the last one shorter, as B9 does (FleetLayout):
    chunk c of group g writes partial slot slot0[g] + c of `slots`."""
    gids: torch.Tensor     # int32 [S]
    order: torch.Tensor    # int32 [S], rows stably sorted by group id
    starts: torch.Tensor   # int32 [G + 1]
    num_groups: int
    max_group: int         # members of the largest group
    slot0: torch.Tensor    # int32 [G], read for chunked groups only
    slots: int             # partial slots: the chunked groups' chunks
    chunk: int             # FLEET_CHUNK when the layout was built


def _chunk_numbering(sizes: torch.Tensor, chunk: int):
    """Each chunked group's first partial slot (its chunks numbered in
    group order along the last axis) and the chunks per group (0 for a
    group of at most `chunk` members)."""
    n_chunks = torch.where(sizes > chunk, -(-sizes // chunk), 0)
    return torch.cumsum(n_chunks, -1) - n_chunks, n_chunks


def group_layout(gids, num_groups: int, device) -> GroupLayout:
    """Build a GroupLayout from host or device group ids (validated to lie
    in [0, num_groups)), chunked by FLEET_CHUNK."""
    g = torch.as_tensor(np.asarray(gids) if not torch.is_tensor(gids)
                        else gids).to(device=device, dtype=torch.int64)
    if g.dim() != 1:
        raise ValueError("group ids must be one-dimensional")
    if g.numel() and (int(g.min()) < 0 or int(g.max()) >= num_groups):
        raise ValueError(f"group ids outside [0, {num_groups})")
    order = torch.sort(g, stable=True).indices
    sizes = torch.bincount(g, minlength=num_groups)
    starts = torch.zeros(num_groups + 1, dtype=torch.int64, device=g.device)
    starts[1:] = torch.cumsum(sizes, 0)
    chunk = FLEET_CHUNK
    slot0, n_chunks = _chunk_numbering(sizes, chunk)
    max_group, slots = (torch.stack([sizes.max(), n_chunks.sum()]).tolist()
                        if num_groups else (0, 0))
    return GroupLayout(g.to(torch.int32), order.to(torch.int32),
                       starts.to(torch.int32), int(num_groups),
                       int(max_group), slot0.to(torch.int32), int(slots),
                       int(chunk))


def _check_shift(func: str, shift: int) -> None:
    if shift and func in TIME_VALUED_FUNCS:
        raise ValueError(f"{func} reads absolute time and cannot run on a "
                         "shifted (rolling) grid")


def _check_tile(ts, values, counts) -> tuple[int, int]:
    S, N = ts.shape
    if N < 1:
        raise ValueError("tile needs at least one column")
    kernels.require(ts, "ts", torch.int32, (S, N))
    kernels.require(values, "values", torch.float64, (S, N))
    kernels.require(counts, "counts", torch.int32, (S,))
    return S, N


class _Scan(NamedTuple):
    """The row scan's outputs over a pass's rows: the cv and cmax scratch
    [irregular rows, N], each row's scratch slot (-1: none), its
    maxPrevInterval and, for stddev/stdvar_over_time, its mean."""
    cv: torch.Tensor
    cmax: torch.Tensor
    slots: torch.Tensor
    mpi: torch.Tensor
    mean: torch.Tensor | None


def _ptr(t):
    return None if t is None else t.data_ptr()


def _c_array(ctype, values):
    return (ctype * len(values))(*values)


def _blocks(tensors):
    """Host arrays of the data pointers of D row blocks' tensors."""
    return _c_array(ctypes.c_void_p, [t.data_ptr() for t in tensors])


def _scan_rows(h, func: str, ts, values, counts, cfg: RollupConfig,
               shift: int, min_ts, stream: int, fleet=None) -> _Scan:
    """The row passes K2, B5, B9 and B13 share: maxPrevInterval per row,
    the row mean for stddev/stdvar_over_time, and the reset-corrected
    counter scratch of the irregular rows for the counter funcs.  `ts`,
    `values`, `counts` are lists of D row blocks' tensors ([S_d, N]; one
    sync for all of them), or, with `fleet`, B9's [B, S, N] stack: fleet is
    (shift [B], min_ts [B], v0 [B, S]), each row taking its stream's shift
    and min_ts, v0 rebasing the scratch.  The pass's row pointers stay
    valid while the returned tensors live."""
    if fleet is None:
        N = ts[0].shape[1]
        rows = [int(t.shape[0]) for t in ts]
    else:
        B, S, N = ts.shape
        rows = [B * S]
    dev = (ts[0] if fleet is None else ts).device
    total = sum(rows)
    counter = func in COUNTER_FUNCS
    instant = int(cfg.start >= cfg.end)
    mpi = torch.empty((total,), dtype=torch.int32, device=dev)
    slots = torch.empty((total,), dtype=torch.int32, device=dev)
    n_irregular = torch.zeros((1,), dtype=torch.int32, device=dev)
    mean = torch.empty((total,), dtype=torch.float64, device=dev) \
        if func in CENTRED_FUNCS else None
    if fleet is None:
        D = len(ts)
        rc = h.vm_rollup_scan(
            D, _blocks(ts), _blocks(values), _blocks(counts),
            _c_array(ctypes.c_longlong, rows), N, int(shift), int(min_ts),
            cfg.step, instant, int(counter), mpi.data_ptr(), slots.data_ptr(),
            n_irregular.data_ptr(), _ptr(mean), stream)
    else:
        rc = h.vm_fleet_rollup_scan(
            ts.data_ptr(), values.data_ptr(), counts.data_ptr(), B, S, N,
            fleet[0].data_ptr(), fleet[1].data_ptr(), cfg.step, instant,
            int(counter), mpi.data_ptr(), slots.data_ptr(),
            n_irregular.data_ptr(), _ptr(mean), stream)
    kernels.check(h, rc, "rollup (row scan)")
    # scratch only for counter rows with a reset, a NaN or -0.0: on the
    # others the reset-corrected counter and its running maximum are the
    # values
    n = int(n_irregular.item()) if counter else 0
    cv = torch.empty((n, N), dtype=torch.float64, device=dev)
    cmax = torch.empty((n, N), dtype=torch.float64, device=dev)
    if n and fleet is None:
        kernels.check(h, h.vm_rollup_prep(
            D, _blocks(values), _blocks(counts),
            _c_array(ctypes.c_longlong, rows), N, slots.data_ptr(),
            cv.data_ptr(), cmax.data_ptr(), stream), "rollup (row prep)")
    elif n:
        kernels.check(h, h.vm_fleet_rollup_prep(
            values.data_ptr(), counts.data_ptr(), slots.data_ptr(),
            fleet[2].data_ptr(), B, S, N, cv.data_ptr(), cmax.data_ptr(),
            stream), "rollup (row prep)")
    return _Scan(cv, cmax, slots, mpi, mean)


def _out_block(out, shape, dev) -> torch.Tensor:
    """A caller's output block: float64 of `shape` on `dev` with unit
    column stride (rows may be a wider tensor's), or a new tensor."""
    if out is None:
        return torch.empty(shape, dtype=torch.float64, device=dev)
    if out.dtype != torch.float64 or tuple(out.shape) != tuple(shape) or \
            out.device != dev:
        raise ValueError(f"out: expected float64 {tuple(shape)} on {dev}, "
                         f"got {out.dtype} {tuple(out.shape)} on "
                         f"{out.device}")
    if len(shape) > 1 and shape[-1] > 1 and out.stride(-1) != 1:
        raise ValueError("out: columns must be contiguous")
    return out


def rollup_tile(func: str, ts: torch.Tensor, values: torch.Tensor,
                counts: torch.Tensor, cfg: RollupConfig, min_ts=MIN_TS_NONE,
                shift: int = 0, out=None,
                force_global: bool = False) -> torch.Tensor:
    """B5: windowed rollup over a tile -> float64 [S, T] (NaN = gap).

    `shift` (ms) rebases tile timestamps onto the cfg grid (rolling tiles:
    shift = query_start - tile_base); `min_ts` is the query's fetch lower
    bound in the shifted frame, gating only previous-sample accesses.
    Time-valued funcs refuse a shift.  `out`, when given, is the [S, T]
    block written (a row block of a gathered tile, or a time shard's
    columns of a wider one).  The pass runs on b5_plan's path;
    `force_global` takes the global search whatever the plan (to hold the
    staged path against it: both give the same bits)."""
    if func not in FUNC_CODES:
        raise ValueError(f"unsupported device rollup func {func!r}")
    _check_shift(func, shift)
    dev = kernels.placement(ts, values, counts)
    T = num_steps(cfg)
    if dev.type == "cpu":
        res = rollup_tile_plain(func, ts - int(shift), values, counts, cfg,
                                min_ts)
        return res if out is None else \
            _out_block(out, res.shape, dev).copy_(res)
    S, N = _check_tile(ts, values, counts)
    out = _out_block(out, (S, T), dev)
    plan = B5_GLOBAL if force_global else b5_plan(
        S, N, T, cfg.step, cfg.lookback,
        scrape_hint(N, T, cfg.step, cfg.lookback), kernels.sm_count(dev))
    h = kernels.lib("rollup")
    stream = kernels.stream_of(dev)
    sc = _scan_rows(h, func, [ts], [values], [counts], cfg, shift, min_ts,
                    stream)
    # `sc` holds the row tensors until the launch is queued: the pointers
    # alone would let the allocator reuse their memory
    kernels.check(h, h.vm_rollup_series(
        ts.data_ptr(), values.data_ptr(), sc.cv.data_ptr(),
        sc.cmax.data_ptr(), sc.slots.data_ptr(), counts.data_ptr(),
        sc.mpi.data_ptr(), _ptr(sc.mean), S, N, T, int(shift), int(min_ts),
        cfg.step, cfg.lookback, float(cfg.start) / 1e3, FUNC_CODES[func],
        out.data_ptr(), out.stride(0) if S else T,
        int(plan.path == K2_STAGED), plan.rows, plan.steps, plan.cap,
        stream), "rollup_tile")
    kernels.LAUNCHES["rollup_tile"] += 1
    return out


def chunked_group_moments(aggr: str, rolled: torch.Tensor,
                          groups: GroupLayout) -> dict[str, torch.Tensor]:
    """partial_group_moments as K2 and B13 fold them: a group of at most
    `groups.chunk` members in one segment; a larger one in chunks of that
    many consecutive members (in the layout's ascending order), whose
    moments merge in chunk order from the empty moments (sums add; an
    extremum keeps the earlier of equal values) -> {name: [G, T]}."""
    G = groups.num_groups
    if groups.slots == 0:
        return partial_group_moments(aggr, rolled, groups.gids, G)
    dev = rolled.device
    S = rolled.shape[0]
    order = groups.order.long()
    starts = groups.starts.long()
    gid_sorted = groups.gids.long()[order]
    sizes = starts[1:] - starts[:-1]
    slot0 = groups.slot0.long()
    chunk = groups.chunk
    pos = torch.arange(S, device=dev) - starts[gid_sorted]
    seg_sorted = torch.where(sizes[gid_sorted] > chunk,
                             G + slot0[gid_sorted] + pos // chunk,
                             gid_sorted)
    seg = torch.empty_like(seg_sorted)
    seg[order] = seg_sorted
    m = partial_group_moments(aggr, rolled, seg, G + groups.slots)
    n_chunks = torch.where(sizes > chunk, -(-sizes // chunk), 0)
    chunked = n_chunks > 0
    acc = {}
    for k, v in m.items():
        acc[k] = v[:G].clone()
        acc[k][chunked] = torch.inf if k == "min" else \
            -torch.inf if k == "max" else 0.0
    for c in range(int(n_chunks.max())):
        has = n_chunks > c
        idx = G + slot0[has] + c
        for k in acc:
            p, a = m[k][idx], acc[k][has]
            acc[k][has] = (torch.where(p < a, p, a) if k == "min" else
                           torch.where(p > a, p, a) if k == "max" else a + p)
    return acc


def rollup_aggregate_tile_plain(func: str, aggr: str, ts, values, counts,
                                groups: GroupLayout, cfg: RollupConfig,
                                shift: int = 0,
                                min_ts=MIN_TS_NONE) -> torch.Tensor:
    """Plain PyTorch version of K2: rollup_tile_plain, then the layout's
    chunked_group_moments, finalized."""
    _check_shift(func, shift)
    rolled = rollup_tile_plain(func, ts - int(shift), values, counts, cfg,
                               min_ts)
    return finalize_group_moments(
        aggr, chunked_group_moments(aggr, rolled, groups))


#: K2's paths (csrc/rollup.cu group_pass): each step's window found by two
#: binary searches of the row in global memory, or in the row's span for
#: the block's step tile, staged in shared memory
K2_GLOBAL, K2_STAGED = 0, 1
K2_THREADS = 128            # kGroupThreads: a thread per step of a tile
_K2_STEPS = (128, 256, 512)  # a tile: 1 to kMaxStepsPerThread steps a thread
_K2_STAGES = 2              # kStages: member rows in flight in a block
_K2_SMEM_MAX = 96 << 10     # a block's staging ring, at most
_K2_BLOCK_ROWS = 64         # rows a block walks at most (FLEET_CHUNK)
_K2_BLOCKS_PER_SM = 4       # blocks the grid keeps when a tile grows
#: row blocks of one group pass (csrc/rollup.cu kMaxShards)
MAX_SHARDS = 16


class K2Plan(NamedTuple):
    """How one K2 or B13 group pass runs (``k2_plan``)."""
    path: int   # K2_GLOBAL or K2_STAGED
    steps: int  # steps of a block's tile
    cap: int    # samples of a row's span a stage holds (staged path)
    smem: int   # bytes of a block's staging ring (staged path)


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def scrape_hint(N: int, T: int, step: int, lookback: int) -> int:
    """The scrape interval (ms) K2's plan sizes its stages for: the
    query's span over the tile's N columns, the average spacing of a row
    that fills its tile over the query.  A tile holding more history, or
    a sparser row, stages fewer samples than planned; a denser row
    overflows a stage and takes the global search."""
    return max(((T - 1) * step + lookback) // max(N, 1), 1)


def _staged_plan(units: int, N: int, T: int, step: int, lookback: int,
                 scrape_hint: int, sms: int) -> K2Plan:
    """The staged walk's plan (csrc/rollup.cu walk_rows) for `units`
    blocks' worth of rows, each walking its rows over a step tile; see
    k2_plan."""
    glob = K2Plan(K2_GLOBAL, K2_THREADS, 0, 0)
    if T < 1 or step < 1 or not 0 <= lookback <= _I32_MAX or \
            (T - 1) * step > _I32_MAX:
        return glob
    hint = max(int(scrape_hint), 1)
    plan = glob
    for steps in _K2_STEPS:
        span = ((min(steps, T) - 1) * step + lookback) // hint + 2
        cap = min(N, span + span // 4 + 16)
        smem = _K2_STAGES * (_align16(4 * cap) + 2 * _align16(8 * cap))
        if smem > _K2_SMEM_MAX:
            break
        if plan.path == K2_STAGED and (
                plan.steps >= T or
                units * -(-T // steps) < _K2_BLOCKS_PER_SM * sms):
            break
        plan = K2Plan(K2_STAGED, steps, cap, smem)
    return plan


@functools.lru_cache(maxsize=256)
def k2_plan(S: int, N: int, T: int, step: int, lookback: int,
            scrape_hint: int, sms: int = 132) -> K2Plan:
    """K2's (and B13's per-shard pass's) plan for S rows of N columns over
    T steps of `step` ms with windows of `lookback` ms, rows scraped every
    `scrape_hint` ms, on a card of ``sms`` SMs.

    Staged when the window grid is monotone in int32 (no step's grid point
    or window start wraps) and a 128-step tile's span fits: a tile of
    `steps` steps spans ((steps - 1) step + lookback) / scrape_hint samples
    plus the one before; a stage holds a quarter more and 16 (jitter), at
    most N, and the ring of 2 stages (cap x 20 B each) at most 96 KiB.
    The tile doubles to 256 and 512 steps while the ring fits, the tile
    does not outgrow T, and the grid keeps 4 blocks an SM (counting S / 64
    groups or chunks).  Otherwise the global search, a step a thread."""
    return _staged_plan(max(-(-S // _K2_BLOCK_ROWS), 1), N, T, step,
                        lookback, scrape_hint, sms)


class B5Plan(NamedTuple):
    """How one B5 rollup_tile call runs (``b5_plan``)."""
    path: int   # K2_GLOBAL or K2_STAGED
    rows: int   # rows a block walks (staged path; 1 on the global path)
    steps: int  # steps of a block's tile
    cap: int    # samples of a row's span a stage holds (staged path)
    smem: int   # bytes of a block's staging ring (staged path)


#: B5's global path: a block per (row, 128-step tile), binary searches
B5_GLOBAL = B5Plan(K2_GLOBAL, 1, K2_THREADS, 0, 0)
_B5_MIN_ROWS = 8            # rows a staged block walks, at least


@functools.lru_cache(maxsize=256)
def b5_plan(S: int, N: int, T: int, step: int, lookback: int,
            scrape_hint: int, sms: int = 132) -> B5Plan:
    """B5's plan for S rows of N columns over T steps (k2_plan's
    arguments): K2's staged walk over blocks of `rows` consecutive rows,
    or B5_GLOBAL.  A block walks 64 rows, halved (to 8 at least) while
    the grid of 128-step tiles keeps fewer than 4 blocks an SM; the tile,
    the stages and the choice of path are k2_plan's for S / rows blocks
    of rows."""
    rows = _K2_BLOCK_ROWS
    while rows > _B5_MIN_ROWS and \
            -(-S // rows) * -(-T // K2_THREADS) < _K2_BLOCKS_PER_SM * sms:
        rows //= 2
    p = _staged_plan(max(-(-S // rows), 1), N, T, step, lookback,
                     scrape_hint, sms)
    if p.path != K2_STAGED:
        return B5_GLOBAL
    return B5Plan(K2_STAGED, rows, p.steps, p.cap, p.smem)


def _check_layouts(layouts, rows) -> tuple[int, int]:
    """(G, chunk) of the row blocks' layouts, validated before their
    pointers cross into C."""
    G, chunk = layouts[0].num_groups, layouts[0].chunk
    for g, S in zip(layouts, rows):
        if g.num_groups != G or g.chunk != chunk:
            raise ValueError("row blocks' layouts differ in groups or chunk")
        kernels.require(g.order, "order", torch.int32, (S,))
        kernels.require(g.starts, "starts", torch.int32, (G + 1,))
        kernels.require(g.slot0, "slot0", torch.int32, (G,))
    return G, chunk


def _group_pass(h, func: str, aggr: str, ts, values, counts, layouts,
                sc: _Scan, cfg: RollupConfig, shift: int, min_ts, out,
                moments: bool, stream: int, what: str) -> K2Plan:
    """Launch K2's group pass (and fold) over D row blocks on one device:
    out [G, T] (D = 1), or the blocks' moments [D, M, G, T]."""
    rows = [int(t.shape[0]) for t in ts]
    N = int(ts[0].shape[1])
    G, chunk = _check_layouts(layouts, rows)
    T = num_steps(cfg)
    plan = k2_plan(sum(rows), N, T, cfg.step, cfg.lookback,
                   scrape_hint(N, T, cfg.step, cfg.lookback),
                   kernels.sm_count(out.device))
    pslots = [g.slots for g in layouts]
    # the chunks' moments (cnt, s1, s2, min, max), folded by a second launch
    partial = (torch.empty((5, sum(pslots), T), dtype=torch.float64,
                           device=out.device) if sum(pslots) else None)
    kernels.check(h, h.vm_rollup_groups(
        len(ts), _blocks(ts), _blocks(values), _blocks(counts),
        _c_array(ctypes.c_longlong, rows), sc.cv.data_ptr(),
        sc.cmax.data_ptr(), sc.slots.data_ptr(), sc.mpi.data_ptr(),
        _ptr(sc.mean), _blocks([g.order for g in layouts]),
        _blocks([g.starts for g in layouts]),
        _blocks([g.slot0 for g in layouts]),
        _c_array(ctypes.c_longlong, pslots), G, N, T, int(shift),
        int(min_ts), cfg.step, cfg.lookback, float(cfg.start) / 1e3,
        FUNC_CODES[func], AGGR_FUNCS[aggr], int(moments), chunk,
        _ptr(partial), int(plan.path == K2_STAGED), plan.steps, plan.cap,
        out.data_ptr(), stream), what)
    return plan


def rollup_aggregate_tile(func: str, aggr: str, ts: torch.Tensor,
                          values: torch.Tensor, counts: torch.Tensor,
                          groups: GroupLayout, cfg: RollupConfig,
                          shift: int = 0,
                          min_ts=MIN_TS_NONE) -> torch.Tensor:
    """K2: fused aggr(rollup(m[d])) over one tile -> float64 [G, T].

    `shift` (ms) rebases tile timestamps onto the cfg grid: rolling tiles
    keep timestamps relative to their original base while the query grid
    advances, so shift = query_start - tile_base.  `min_ts` is the query's
    fetch lower bound in the shifted frame.  cfg is the normalized (start
    0) grid, or the absolute one for the time-valued funcs.  The group
    pass runs on k2_plan's path; groups of more than groups.chunk members
    walk in chunks whose moments a second launch folds."""
    if func not in FUNC_CODES:
        raise ValueError(f"unsupported device rollup func {func!r}")
    if aggr not in AGGR_FUNCS:
        raise ValueError(f"unsupported aggregate {aggr!r}")
    _check_shift(func, shift)
    dev = kernels.placement(ts, values, counts, groups.gids, groups.order,
                            groups.starts, groups.slot0)
    if dev.type == "cpu":
        return rollup_aggregate_tile_plain(func, aggr, ts, values, counts,
                                           groups, cfg, shift, min_ts)
    _check_tile(ts, values, counts)
    h = kernels.lib("rollup")
    stream = kernels.stream_of(dev)
    sc = _scan_rows(h, func, [ts], [values], [counts], cfg, shift, min_ts,
                    stream)
    out = torch.empty((groups.num_groups, num_steps(cfg)),
                      dtype=torch.float64, device=dev)
    _group_pass(h, func, aggr, [ts], [values], [counts], [groups], sc, cfg,
                shift, min_ts, out, False, stream,
                "rollup_aggregate_tile (group pass)")
    kernels.LAUNCHES["rollup_aggregate_tile"] += 1
    return out


def rollup_group_moments_plain(func: str, aggr: str, ts, values, counts,
                               groups: GroupLayout, cfg: RollupConfig,
                               shift: int = 0,
                               min_ts=MIN_TS_NONE) -> torch.Tensor:
    """Plain version of B13's per-shard pass over one shard's tile:
    rollup_tile_plain, then chunked_group_moments stacked in MOMENTS order
    -> [M, G, T]."""
    _check_shift(func, shift)
    rolled = rollup_tile_plain(func, ts - int(shift), values, counts, cfg,
                               min_ts)
    m = chunked_group_moments(aggr, rolled, groups)
    return torch.stack([m[k] for k in MOMENTS[aggr]])


def rollup_group_moments(func: str, aggr: str, ts: list, values: list,
                         counts: list, groups: list, cfg: RollupConfig,
                         shift: int = 0, min_ts=MIN_TS_NONE,
                         out=None) -> torch.Tensor:
    """B13's per-shard pass over D series shards on one device (lists of
    each shard's ts, values, counts and GroupLayout; D <= MAX_SHARDS):
    K2's group walk over each shard's row block, writing the aggregate's
    moments (MOMENTS[aggr]) -> float64 [D, M, G, T] instead of finalizing
    them, in one row scan (one host sync) and one group pass (and fold)
    for the D shards.  A shard's chunked groups fold within the shard, in
    chunk order.  `out`, when given, is those D shards' block of the
    [D', M, G, T] buffer the combine reads."""
    if func not in FUNC_CODES:
        raise ValueError(f"unsupported device rollup func {func!r}")
    if aggr not in AGGR_FUNCS:
        raise ValueError(f"unsupported aggregate {aggr!r}")
    _check_shift(func, shift)
    D = len(ts)
    if not 1 <= D <= MAX_SHARDS or not \
            len(values) == len(counts) == len(groups) == D:
        raise ValueError(f"1 to {MAX_SHARDS} shards of ts, values, counts "
                         "and layouts expected")
    dev = kernels.placement(*ts, *values, *counts,
                            *(x for g in groups for x in (
                                g.gids, g.order, g.starts, g.slot0)))
    if dev.type == "cpu":
        res = torch.stack([rollup_group_moments_plain(
            func, aggr, *a, cfg, shift, min_ts)
            for a in zip(ts, values, counts, groups)])
        return res if out is None else \
            _out_block(out, res.shape, dev).copy_(res)
    N = _check_tile(ts[0], values[0], counts[0])[1]
    for t, v, c in zip(ts, values, counts):
        if _check_tile(t, v, c)[1] != N:
            raise ValueError("shards differ in columns")
    out = _out_block(out, (D, len(MOMENTS[aggr]), groups[0].num_groups,
                           num_steps(cfg)), dev)
    if not out.is_contiguous():
        raise ValueError("out: must be contiguous")
    h = kernels.lib("rollup")
    stream = kernels.stream_of(dev)
    sc = _scan_rows(h, func, ts, values, counts, cfg, shift, min_ts, stream)
    _group_pass(h, func, aggr, ts, values, counts, groups, sc, cfg, shift,
                min_ts, out, True, stream,
                "sharded_rollup_aggregate (moments)")
    kernels.LAUNCHES["rollup_group_moments"] += 1
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


def append_plan(K: int) -> int:
    """Lanes a row of K3 and B10's kernel (csrc/tile.cu append_rows): the
    least power of two >= K / 2, at least 4 and at most a warp.  Both
    callers pad K to a multiple of 8: the K of 8 that a refresh's one
    scrape and a steady fleet interval's four pad to takes 4 lanes
    (measured fastest at the fleet's 4 live of 8, ahead of 2 and 8 lanes,
    a warp and a thread a row: PERF.md, B10), K 16 and 24 after a gap 8
    and 16, the 30-minute resume's K of about 120 a warp."""
    half = -(-int(K) // 2)
    return min(32, max(4, 1 << max(half - 1, 0).bit_length()))


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
        S, N, K, append_plan(K), kernels.stream_of(dev)), "append_tile")
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


# ---------------------------------------------------------------------------
# B9 / B10 / B11: the fleet's passes over a bucket's [B, S, N] stack.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FleetLayout:
    """Group ids of a fleet bucket's [B, S] rows plus each stream's member
    lists: stream b's group g owns rows order[b, starts[b, g]:starts[b,
    g + 1]], ascending.  B9 walks a group of more than `chunk` members in
    chunks of `chunk` consecutive members, the last one shorter: the
    chunks depend on nothing but the group's own size.  Chunk c of stream
    b's group g writes partial slot slot0[b, g] + c of the stream's
    `slots`."""
    gids: torch.Tensor     # int32 [B, S]
    order: torch.Tensor    # int32 [B, S], each stream's rows by group id
    starts: torch.Tensor   # int32 [B, G + 1]
    num_groups: int
    max_group: int         # members of the largest group of any stream
    slot0: torch.Tensor    # int32 [B, G], read for chunked groups only
    slots: int             # partial slots per stream: its groups' chunks
    chunk: int             # FLEET_CHUNK when the layout was built


def fleet_chunks(layout: FleetLayout) -> int:
    """Blocks of B9's grid per (stream, group, step tile): the chunks of
    the layout's largest group (1 when no group is chunked)."""
    m = layout.max_group
    return -(-m // layout.chunk) if m > layout.chunk else 1


def fleet_layout(gids, num_groups: int, device) -> FleetLayout:
    """Build a FleetLayout from host or device group ids [B, S] (validated
    to lie in [0, num_groups)), chunked by FLEET_CHUNK.  A bucket builds it
    once per upload: a member's group ids are fixed while it lives."""
    g = torch.as_tensor(np.asarray(gids) if not torch.is_tensor(gids)
                        else gids).to(device=device, dtype=torch.int64)
    if g.dim() != 2:
        raise ValueError("fleet group ids must be [B, S]")
    if g.numel() and (int(g.min()) < 0 or int(g.max()) >= num_groups):
        raise ValueError(f"group ids outside [0, {num_groups})")
    order = torch.sort(g, dim=1, stable=True).indices
    sizes = torch.zeros((g.shape[0], num_groups), dtype=torch.int64,
                        device=g.device).scatter_add_(1, g,
                                                      torch.ones_like(g))
    starts = torch.zeros((g.shape[0], num_groups + 1), dtype=torch.int64,
                         device=g.device)
    starts[:, 1:] = torch.cumsum(sizes, 1)
    # each stream's chunked groups numbered in group order
    chunk = FLEET_CHUNK
    slot0, n_chunks = _chunk_numbering(sizes, chunk)
    max_group, slots = (torch.stack([sizes.max(), n_chunks.sum(1).max()])
                        .tolist() if sizes.numel() else (0, 0))
    return FleetLayout(g.to(torch.int32), order.to(torch.int32),
                       starts.to(torch.int32), int(num_groups),
                       int(max_group), slot0.to(torch.int32), int(slots),
                       int(chunk))


def fleet_rollup_aggregate_tile_plain(func: str, cfg: RollupConfig,
                                      layout: FleetLayout, ts, values,
                                      counts, aggr, shift, min_ts,
                                      v0) -> torch.Tensor:
    """Plain PyTorch version of B9: per stream b, rollup_tile_plain on
    ts[b] - shift[b] with min_ts[b] and v0[b], then aggregate_groups under
    the aggregate aggr[b] names."""
    outs = []
    for b in range(ts.shape[0]):
        code = int(aggr[b])
        if code not in _AGGR_NAMES:
            raise ValueError(f"unknown aggregate code {code}")
        rolled = rollup_tile_plain(func, ts[b] - int(shift[b]), values[b],
                                   counts[b], cfg, int(min_ts[b]), v0[b])
        outs.append(aggregate_groups(_AGGR_NAMES[code], rolled,
                                     layout.gids[b], layout.num_groups))
    return torch.stack(outs)


def fleet_rollup_aggregate_tile(func: str, cfg: RollupConfig,
                                layout: FleetLayout, ts: torch.Tensor,
                                values: torch.Tensor, counts: torch.Tensor,
                                aggr: torch.Tensor, shift: torch.Tensor,
                                min_ts: torch.Tensor,
                                v0: torch.Tensor, out=None) -> torch.Tensor:
    """B9: aggr(rollup(m[d])) for every stream of a fleet bucket in one
    launch -> float64 [B, G, T] (`out`, when given: a stream shard's block
    of a bucket's output, B14).

    ts int32 [B, S, N], values float64 [B, S, N], counts int32 [B, S];
    per stream (int32 [B]) the aggregate code (FLEET_AGGR_CODES), the grid
    shift (query start - member base, ms) and the fetch bound min_ts in the
    shifted frame; v0 float64 [B, S] the rebase offsets (zeros on a
    float64 bucket).  cfg is the bucket's start-0 grid.  Padded rows
    (counts 0), groups and slots come out NaN; steps past a member's own T
    are the caller's to slice off."""
    if func not in FLEET_FUNCS:
        raise ValueError(f"{func!r} does not roll in a fleet bucket")
    dev = kernels.placement(ts, values, counts, layout.gids, layout.order,
                            layout.starts, aggr, shift, min_ts, v0)
    if dev.type == "cpu":
        res = fleet_rollup_aggregate_tile_plain(func, cfg, layout, ts,
                                                values, counts, aggr, shift,
                                                min_ts, v0)
        return res if out is None else \
            _out_block(out, res.shape, dev).copy_(res)
    if ts.dim() != 3 or ts.shape[2] < 1:
        raise ValueError("fleet planes must be [B, S, N] with N >= 1")
    B, S, N = ts.shape
    G = layout.num_groups
    T = num_steps(cfg)
    kernels.require(ts, "ts", torch.int32, (B, S, N))
    kernels.require(values, "values", torch.float64, (B, S, N))
    kernels.require(counts, "counts", torch.int32, (B, S))
    kernels.require(layout.order, "order", torch.int32, (B, S))
    kernels.require(layout.starts, "starts", torch.int32, (B, G + 1))
    kernels.require(layout.slot0, "slot0", torch.int32, (B, G))
    for name, t in (("aggr", aggr), ("shift", shift), ("min_ts", min_ts)):
        kernels.require(t, name, torch.int32, (B,))
    kernels.require(v0, "v0", torch.float64, (B, S))
    h = kernels.lib("rollup")
    stream = kernels.stream_of(dev)
    sc = _scan_rows(h, func, ts, values, counts, cfg, 0, 0, stream,
                    fleet=(shift, min_ts, v0))
    out = _out_block(out, (B, G, T), dev)
    if not out.is_contiguous():
        raise ValueError("out: must be contiguous")
    chunks = fleet_chunks(layout)
    # the chunks' moments (cnt, s1, s2, min, max), folded by a second launch
    partial = (torch.empty((5, B * layout.slots, T), dtype=torch.float64,
                           device=dev) if chunks > 1 else None)
    kernels.check(h, h.vm_fleet_rollup_groups(
        ts.data_ptr(), values.data_ptr(), sc.cv.data_ptr(),
        sc.cmax.data_ptr(), sc.slots.data_ptr(), counts.data_ptr(),
        sc.mpi.data_ptr(), _ptr(sc.mean), v0.data_ptr(),
        layout.order.data_ptr(), layout.starts.data_ptr(), shift.data_ptr(),
        min_ts.data_ptr(), aggr.data_ptr(), B, S, G, N, T, cfg.step,
        cfg.lookback, float(cfg.start) / 1e3, FUNC_CODES[func],
        layout.slot0.data_ptr(), layout.chunk, chunks, layout.slots,
        None if partial is None else partial.data_ptr(), out.data_ptr(),
        stream), "fleet_rollup_aggregate_tile")
    del sc, partial  # they live until the launch is queued
    kernels.LAUNCHES["fleet_rollup_aggregate_tile"] += 1
    return out


def _fleet_dims(ts, values, counts) -> tuple[int, int, int]:
    if ts.dim() != 3:
        raise ValueError("fleet planes must be [B, S, N]")
    B, S, N = ts.shape
    kernels.require(ts, "ts", torch.int32, (B, S, N))
    kernels.require(values, "values", torch.float64, (B, S, N))
    kernels.require(counts, "counts", torch.int32, (B, S))
    return B, S, N


def fleet_append_tile_plain(ts, values, counts, new_ts, new_values,
                            new_counts):
    """Plain PyTorch version of B10: K3's plain version over the B x S
    rows, in place."""
    B, S, N = ts.shape
    K = new_ts.shape[2]
    append_tile_plain(ts.view(B * S, N), values.view(B * S, N),
                      counts.view(B * S), new_ts.reshape(B * S, K),
                      new_values.reshape(B * S, K), new_counts.reshape(B * S))
    return ts, values, counts


def fleet_append_tile(ts: torch.Tensor, values: torch.Tensor,
                      counts: torch.Tensor, new_ts: torch.Tensor,
                      new_values: torch.Tensor, new_counts: torch.Tensor):
    """B10: one launch scatters every staged stream's suffix columns
    [B, S, K] onto the bucket's [B, S, N] planes, IN PLACE (the reference
    donated them); streams with nothing staged carry new_counts 0.
    Returns the same three tensors."""
    dev = kernels.placement(ts, values, counts, new_ts, new_values,
                            new_counts)
    if dev.type == "cpu":
        return fleet_append_tile_plain(ts, values, counts, new_ts,
                                       new_values, new_counts)
    B, S, N = _fleet_dims(ts, values, counts)
    K = new_ts.shape[2] if new_ts.dim() == 3 else -1
    kernels.require(new_ts, "new_ts", torch.int32, (B, S, K))
    kernels.require(new_values, "new_values", torch.float64, (B, S, K))
    kernels.require(new_counts, "new_counts", torch.int32, (B, S))
    h = kernels.lib("tile")
    kernels.check(h, h.vm_fleet_append_tile(
        ts.data_ptr(), values.data_ptr(), counts.data_ptr(),
        new_ts.data_ptr(), new_values.data_ptr(), new_counts.data_ptr(),
        B, S, N, K, append_plan(K), kernels.stream_of(dev)),
        "fleet_append_tile")
    kernels.LAUNCHES["fleet_append_tile"] += 1
    return ts, values, counts


def fleet_compact_tile_plain(ts, values, counts, cutoff, delta):
    """Plain PyTorch version of B11: K4's plain version with the cutoff
    and delta of each row's stream; fresh output tensors."""
    B, S, N = ts.shape
    k = torch.arange(N, device=ts.device)
    cut = cutoff.to(torch.int32)[:, None, None]
    valid = k < counts[..., None]
    drop = (valid & (ts < cut)).sum(dim=2).to(torch.int32)
    new_counts = counts - drop
    idx = (drop.to(torch.int64)[..., None] + k).clamp(0, N - 1)
    live = k < new_counts[..., None]
    ts2 = torch.where(live, torch.take_along_dim(ts, idx, 2) -
                      delta.to(torch.int32)[:, None, None],
                      int(TS_PAD)).to(torch.int32)
    v2 = torch.where(live, torch.take_along_dim(values, idx, 2), 0.0)
    return ts2, v2, new_counts


def fleet_compact_tile(ts: torch.Tensor, values: torch.Tensor,
                       counts: torch.Tensor, cutoff: torch.Tensor,
                       delta: torch.Tensor):
    """B11: window-slide compaction of every stream of a bucket at its own
    cutoff and delta (int32 [B], tile-relative ms): each row drops its
    samples older than the cutoff, shifts the survivors to the front and
    rebases them by -delta.  A slot with cutoff 0 drops only live samples
    with ts < 0, as in the reference, which compacts every slot.  Returns
    NEW (ts, values, counts); the caller drops the old tensors."""
    dev = kernels.placement(ts, values, counts, cutoff, delta)
    if dev.type == "cpu":
        return fleet_compact_tile_plain(ts, values, counts, cutoff, delta)
    B, S, N = _fleet_dims(ts, values, counts)
    kernels.require(cutoff, "cutoff", torch.int32, (B,))
    kernels.require(delta, "delta", torch.int32, (B,))
    ts2 = torch.empty_like(ts)
    v2 = torch.empty_like(values)
    c2 = torch.empty_like(counts)
    h = kernels.lib("tile")
    kernels.check(h, h.vm_fleet_compact_tile(
        ts.data_ptr(), values.data_ptr(), counts.data_ptr(), ts2.data_ptr(),
        v2.data_ptr(), c2.data_ptr(), cutoff.data_ptr(), delta.data_ptr(),
        B, S, N, kernels.stream_of(dev)), "fleet_compact_tile")
    kernels.LAUNCHES["fleet_compact_tile"] += 1
    return ts2, v2, c2


# ---------------------------------------------------------------------------
# B6 / B7 / B8: selections over a rolled tile.
# ---------------------------------------------------------------------------

def _topk_key(rolled: torch.Tensor, bottom: bool) -> torch.Tensor:
    bad = torch.isnan(rolled)
    return torch.where(bad, -torch.inf, -rolled if bottom else rolled)


def topk_select_plain(rolled: torch.Tensor, k: int, bottom: bool):
    """Plain version of the B6 selection: per step, the k series with the
    largest key NaN ? -inf : (bottom ? -v : v) in lax.top_k's order (+0.0
    above -0.0, ties to the lower index) -> (idx int32 [T, k], sel_nan
    bool [T, k])."""
    bits = _topk_key(rolled, bottom).T.contiguous().view(torch.int64)
    # float64 total order as int64: flip the magnitude bits of negatives
    order = torch.where(bits < 0, bits ^ 0x7FFFFFFFFFFFFFFF, bits)
    idx = torch.sort(order, dim=1, descending=True, stable=True).indices[:, :k]
    sel_nan = torch.gather(torch.isnan(rolled).T, 1, idx)
    return idx.to(torch.int32), sel_nan


#: largest k of B6's scan path (csrc/select.cu kRegMax); larger k sorts
K_REG = 64
_MAX_CLUSTER = 16  # most blocks of a cluster (kMaxCluster)
_MIN_MEMBER_ROWS = 256  # rows a cluster member streams, at least
_SORT_CHUNK_BYTES = 256 << 20  # the sort path's codes and flags per chunk


class TopkPlan(NamedTuple):
    """How one B6 call runs (``topk_plan``).  The scan path (k <= K_REG)
    uses cluster and rows; the sort path chunk, blocks and scratch."""
    cluster: int  # blocks of a 32-step tile's cluster, one row range each
    rows: int     # rows of a cluster member's range
    chunk: int    # steps the sort path transposes per pass
    blocks: int   # sort blocks walking a chunk's steps
    scratch: int  # bytes: a chunk's codes and flags, each block's pairs


def _round256(n: int) -> int:
    return -(-n // 256) * 256


@functools.lru_cache(maxsize=256)
def topk_plan(S: int, T: int, k: int, sms: int = 132) -> TopkPlan:
    """B6's plan for (S, T, k) on a card of ``sms`` SMs.  Scan path: the
    cluster of a 32-step tile doubled up to 16 while the grid has under 2
    blocks an SM and every member keeps 256 rows or more.  Sort path:
    chunks of steps whose codes and flags fill at most 256 MiB, two blocks
    an SM."""
    if not 1 <= k <= S:
        raise ValueError(f"k={k} outside [1, {S}]")
    if k <= K_REG:
        tiles = -(-T // 32)
        cluster = 1
        while (cluster < _MAX_CLUSTER and tiles * cluster < 2 * sms and
               S >= 2 * cluster * _MIN_MEMBER_ROWS):
            cluster *= 2
        return TopkPlan(cluster, -(-S // cluster), 0, 0, 0)
    chunk = min(T, max(32, _SORT_CHUNK_BYTES // (9 * S) // 32 * 32))
    blocks = min(2 * sms, chunk)
    scratch = (_round256(8 * chunk * S) + _round256(chunk * S) +
               blocks * _round256(24 * k))
    return TopkPlan(1, S, chunk, blocks, scratch)


def topk_select(rolled: torch.Tensor, k: int, bottom: bool):
    """B6 selection over a rolled tile [S, T], 1 <= k <= S -> (idx int32
    [T, k], sel_nan bool [T, k]), in jax.lax.top_k's order."""
    S, T = rolled.shape
    if not 1 <= k <= S:
        raise ValueError(f"k={k} outside [1, {S}]")
    dev = kernels.placement(rolled)
    if dev.type == "cpu":
        return topk_select_plain(rolled, k, bottom)
    kernels.require(rolled, "rolled", torch.float64, (S, T))
    k = int(k)
    plan = topk_plan(S, T, k, kernels.sm_count(dev))
    idx = torch.empty((T, k), dtype=torch.int32, device=dev)
    sel_nan = torch.empty((T, k), dtype=torch.bool, device=dev)
    scratch = (torch.empty(plan.scratch, dtype=torch.uint8, device=dev)
               if plan.scratch else None)
    h = kernels.lib("select")
    kernels.check(h, h.vm_topk_select(
        rolled.data_ptr(), S, T, k, int(bool(bottom)), plan.cluster,
        plan.rows, plan.chunk, plan.blocks,
        None if scratch is None else scratch.data_ptr(), plan.scratch,
        idx.data_ptr(), sel_nan.data_ptr(), kernels.stream_of(dev)),
        "topk_select_tile")
    kernels.LAUNCHES["topk_select_tile"] += 1
    return idx, sel_nan


def topk_select_tile(func: str, ts, values, counts, cfg: RollupConfig,
                     k: int, bottom: bool, min_ts=MIN_TS_NONE):
    """Per-step topk/bottomk over a rolled tile: the [S, T] rollup stays on
    the device; only [T, k] winner indices and NaN flags come back.
    Returns (rolled, idx, sel_nan)."""
    rolled = rollup_tile(func, ts, values, counts, cfg, min_ts)
    idx, sel_nan = topk_select(rolled, k, bottom)
    return rolled, idx, sel_nan


def take_rows_plain(rolled: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """Plain row gather, as jnp.take's fill mode: a negative index counts
    from the end, and one outside [-S, S) gives a NaN row."""
    S = rolled.shape[0]
    sel = sel.to(torch.int64)
    sel = torch.where(sel < 0, sel + S, sel)
    ok = (sel >= 0) & (sel < S)
    rows = rolled.index_select(0, sel.clamp(0, max(S - 1, 0)))
    return torch.where(ok[:, None], rows, torch.nan)


def take_rows(rolled: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """Row gather on a device-resident rolled tile: rolled [S, T], sel
    int32 or int64 [m] -> [m, T] (the D2H tail of the topk kernels)."""
    dev = kernels.placement(rolled, sel)
    if dev.type == "cpu":
        return take_rows_plain(rolled, sel)
    S, T = rolled.shape
    kernels.require(rolled, "rolled", torch.float64, (S, T))
    if sel.dtype not in (torch.int32, torch.int64) or sel.dim() != 1 or \
            not sel.is_contiguous():
        raise TypeError(f"sel: expected a contiguous int32 or int64 vector, "
                        f"got {sel.dtype}{tuple(sel.shape)}")
    M = sel.shape[0]
    out = torch.empty((M, T), dtype=torch.float64, device=dev)
    if M == 0 or T == 0:
        return out
    h = kernels.lib("select")
    kernels.check(h, h.vm_take_rows(
        rolled.data_ptr(), S, T, sel.data_ptr(), M,
        int(sel.dtype == torch.int64), out.data_ptr(),
        kernels.stream_of(dev)), "take_rows")
    kernels.LAUNCHES["take_rows"] += 1
    return out


def rank_rows_plain(rolled: torch.Tensor, kind: str) -> torch.Tensor:
    """Plain version of the B7 statistic: one float64 per series over its
    non-NaN steps (NaN where it has none)."""
    if kind not in RANK_KINDS:
        raise ValueError(f"unknown rank kind {kind!r}")
    bad = torch.isnan(rolled)
    n = (~bad).sum(dim=1)
    T = rolled.shape[1]
    if kind == "max":
        r = torch.where(bad, -torch.inf, rolled).amax(dim=1)
    elif kind == "min":
        r = torch.where(bad, torch.inf, rolled).amin(dim=1)
    elif kind == "avg":
        r = _serial_cumsum(torch.where(bad, 0.0, rolled))[:, -1] / \
            n.clamp(min=1).to(rolled.dtype)
    elif kind == "median":
        sv = torch.sort(torch.where(bad, torch.inf, rolled), dim=1).values
        pos = 0.5 * (n - 1).clamp(min=0).to(rolled.dtype)
        j0 = torch.floor(pos).to(torch.int64)
        j1 = torch.minimum(j0 + 1, (n - 1).clamp(min=0))
        a = torch.gather(sv, 1, j0[:, None])[:, 0]
        b = torch.gather(sv, 1, j1[:, None])[:, 0]
        r = a + (pos - j0.to(rolled.dtype)) * (b - a)
    else:  # last
        j = T - 1 - torch.argmax(torch.flip(~bad, dims=[1]).to(torch.int8),
                                 dim=1)
        r = torch.gather(rolled, 1, j[:, None])[:, 0]
    return torch.where(n == 0, torch.nan, r)


#: B7's median paths (csrc/select.cu RankPath): a warp per row, several
#: rows a block; a block per row with the row staged; a block per row
#: reading global memory
RANK_WARP, RANK_BLOCK, RANK_GLOBAL = 0, 1, 2
_RANK_WARP_MAX = 1024        # steps of the warp path's longest row
_RANK_WARP_ROWS = 8          # rows a warp-path block, at most (kRankWarps)
_RANK_STAGE_MAX = 24576      # steps a block stages (kStageMax)


class RankPlan(NamedTuple):
    """How B7's median runs over [S, T] (``rank_plan``)."""
    path: int   # RANK_WARP, RANK_BLOCK or RANK_GLOBAL
    rows: int   # rows a block (a warp each on the warp path; else 1)
    smem: int   # bytes of staged keys a block


@functools.lru_cache(maxsize=256)
def rank_plan(S: int, T: int, sms: int = 132) -> RankPlan:
    """B7's median plan for S rows of T steps on a card of `sms` SMs.  Up
    to _RANK_WARP_MAX steps a warp takes a row (its radix passes need no
    block barrier, and its last candidates fit its 32 lanes), 8 rows a
    block (64 KiB of keys at most), fewer where that would leave SMs
    without a block; longer rows take a block each, staged up to
    _RANK_STAGE_MAX steps (192 KiB of keys), read from global memory
    above."""
    if T <= _RANK_WARP_MAX:
        rows = max(1, min(_RANK_WARP_ROWS, -(-S // max(sms, 1))))
        return RankPlan(RANK_WARP, rows, 8 * rows * T)
    if T <= _RANK_STAGE_MAX:
        return RankPlan(RANK_BLOCK, 1, 8 * T)
    return RankPlan(RANK_GLOBAL, 1, 0)


def rank_rows(rolled: torch.Tensor, kind: str) -> torch.Tensor:
    """B7 statistic over a rolled tile [S, T] -> float64 [S]; the median
    on rank_plan's path."""
    if kind not in RANK_KINDS:
        raise ValueError(f"unknown rank kind {kind!r}")
    dev = kernels.placement(rolled)
    if dev.type == "cpu":
        return rank_rows_plain(rolled, kind)
    S, T = rolled.shape
    kernels.require(rolled, "rolled", torch.float64, (S, T))
    rank = torch.empty((S,), dtype=torch.float64, device=dev)
    plan = rank_plan(S, T, kernels.sm_count(dev))
    h = kernels.lib("select")
    kernels.check(h, h.vm_rank_rows(
        rolled.data_ptr(), S, T, RANK_KINDS[kind], plan.path, plan.rows,
        rank.data_ptr(), kernels.stream_of(dev)), "rank_tile")
    kernels.LAUNCHES["rank_tile"] += 1
    return rank


def rank_tile(func: str, kind: str, ts, values, counts, cfg: RollupConfig,
              min_ts=MIN_TS_NONE):
    """topk_<kind>/bottomk_<kind> ranking: the whole-series statistic on
    the device; one float per series comes back.  Returns (rolled,
    rank)."""
    rolled = rollup_tile(func, ts, values, counts, cfg, min_ts)
    return rolled, rank_rows(rolled, kind)


def dense_by_group(rolled: torch.Tensor, groups: GroupLayout) -> torch.Tensor:
    """The reference's dense [G, M, T] of a rolled tile: each group's rows
    in ascending order (the reference's slots), NaN past the group's
    size."""
    S, T = rolled.shape
    dev = rolled.device
    order = groups.order.to(torch.int64)
    gid_sorted = groups.gids.to(torch.int64)[order]
    slot_sorted = torch.arange(S, device=dev) - \
        groups.starts.to(torch.int64)[gid_sorted]
    dense = torch.full((groups.num_groups, max(groups.max_group, 1), T),
                       torch.nan, dtype=rolled.dtype, device=dev)
    dense[gid_sorted, slot_sorted] = rolled[order]
    return dense


def quantile_groups_plain(rolled: torch.Tensor, groups: GroupLayout,
                          phi: float) -> torch.Tensor:
    """Plain version of the B8 quantile, as the reference computes it: the
    rolled rows scattered into a dense [G, M, T] by slot within group,
    sorted along M (NaN last), interpolated at clip(phi, 0, 1) (n - 1)."""
    G = groups.num_groups
    T = rolled.shape[1]
    dev = rolled.device
    dsort = torch.sort(dense_by_group(rolled, groups), dim=1,
                       stable=True).values
    n = torch.zeros((G, T), dtype=torch.int64, device=dev).index_add_(
        0, groups.gids.to(torch.int64), (~torch.isnan(rolled)).to(torch.int64))
    rank = min(max(float(phi), 0.0), 1.0) * (n - 1).clamp(min=0).to(
        rolled.dtype)
    lo = torch.floor(rank).to(torch.int64)
    hi = torch.ceil(rank).to(torch.int64)
    v_lo = torch.gather(dsort, 1, lo[:, None, :])[:, 0]
    v_hi = torch.gather(dsort, 1, hi[:, None, :])[:, 0]
    q = v_lo + (rank - lo.to(rolled.dtype)) * (v_hi - v_lo)
    if phi < 0:
        q = torch.full_like(q, -torch.inf)
    if phi > 1:
        q = torch.full_like(q, torch.inf)
    return torch.where(n > 0, q, torch.nan)


#: B8's paths (csrc/quantile.cu Path)
Q_WARP, Q_BLOCK, Q_CLUSTER = 0, 1, 2
_Q_WARP_MAX = 32             # members of quantile_warp's largest group
_Q_STAGE_MAX = 24576         # keys a block stages (kStageMax)
_Q_MIN_MEMBER_KEYS = 2048    # keys a cluster member takes, at least


class QuantilePlan(NamedTuple):
    """How one B8 call runs (``quantile_plan``)."""
    path: int     # Q_WARP, Q_BLOCK or Q_CLUSTER
    cluster: int  # blocks of one (group, step)
    slice: int    # keys a block takes: the largest group, or its share
    staged: int   # 1 when a block stages its keys in shared memory


@functools.lru_cache(maxsize=256)
def quantile_plan(G: int, T: int, max_group: int,
                  sms: int = 132) -> QuantilePlan:
    """B8's plan for G groups of at most max_group members over T steps on
    a card of ``sms`` SMs.  Up to 32 members: a warp per (group, step).
    Otherwise one block per (group, step), its keys staged when they fit
    (_Q_STAGE_MAX); where G x T leaves SMs idle, a cluster per (group,
    step), doubled up to 16 while the grid stays within one block an SM
    and every member keeps 2048 keys or more, each member staging its
    slice when it fits."""
    if max_group <= _Q_WARP_MAX:
        return QuantilePlan(Q_WARP, 1, max_group, 0)
    pairs = G * T
    cluster = 1
    while (cluster < _MAX_CLUSTER and pairs * cluster * 2 <= sms and
           max_group >= 2 * cluster * _Q_MIN_MEMBER_KEYS):
        cluster *= 2
    part = -(-max_group // cluster)
    return QuantilePlan(Q_CLUSTER if cluster > 1 else Q_BLOCK, cluster,
                        part, int(part <= _Q_STAGE_MAX))


def quantile_groups(rolled: torch.Tensor, groups: GroupLayout,
                    phi: float) -> torch.Tensor:
    """B8 quantile over a rolled tile [S, T] by group -> float64 [G, T]."""
    dev = kernels.placement(rolled, groups.gids, groups.order, groups.starts)
    if dev.type == "cpu":
        return quantile_groups_plain(rolled, groups, phi)
    S, T = rolled.shape
    G = groups.num_groups
    kernels.require(rolled, "rolled", torch.float64, (S, T))
    kernels.require(groups.order, "order", torch.int32, (S,))
    kernels.require(groups.starts, "starts", torch.int32, (G + 1,))
    out = torch.empty((G, T), dtype=torch.float64, device=dev)
    plan = quantile_plan(G, T, groups.max_group, kernels.sm_count(dev))
    h = kernels.lib("quantile")
    kernels.check(h, h.vm_quantile_groups(
        rolled.data_ptr(), T, groups.order.data_ptr(),
        groups.starts.data_ptr(), G, plan.path, plan.cluster, plan.slice,
        plan.staged, float(phi), out.data_ptr(), kernels.stream_of(dev)),
        "rollup_quantile_tile")
    kernels.LAUNCHES["rollup_quantile_tile"] += 1
    return out


def rollup_quantile_tile(func: str, phi: float, ts, values, counts,
                         groups: GroupLayout, cfg: RollupConfig,
                         shift: int = 0, min_ts=MIN_TS_NONE) -> torch.Tensor:
    """Fused quantile(phi, rollup(m[d])) by (...) -> float64 [G, T]:
    B5 on the (shifted) tile, then B8 over each group's members."""
    rolled = rollup_tile(func, ts, values, counts, cfg, min_ts, shift)
    return quantile_groups(rolled, groups, phi)
