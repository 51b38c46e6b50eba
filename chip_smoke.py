#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's device query engine on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--full-hours H]

Runs only the port (``victoriametrics_tpu_torch``), never JAX.  Phases,
each printing one JSON line:

  build       compile csrc/*.cu with nvcc for sm_90a, one process per
              source, all started together
  kernels     K1 decode_tiles, K2 rollup_aggregate_tile, K3 append_tile
              and K4 compact_tile against their plain PyTorch versions on
              the card, at the dashboard shapes and on ragged edge-case
              rows; times each with CUDA events
  dashboard   the main path: a cold ``sum by (instance)(rate(m[5m]))``
              over 8192 counters x 6 h at 15 s (256 instances, step 60 s),
              then 6 rolling refreshes through advance_rolling and
              run_fused_on_tiles with new scrapes ingested in between
              (one refresh resumes after a long pause and slides the
              window with compact_window); every refresh is held against
              a cold rebuild at rtol 1e-12
  full_width  BASELINE config 2: 100,000 counters x 24 h at 15 s, 32
              series per instance, step 15 s, window 5 m, as one cold
              query with its own launch counts; K1 and K2 are checked
              against their plain versions in row chunks
  uploads     (inside kernels and full_width) both host->device paths of
              the tile cache, pinned-staged and direct, timed on a
              refresh's new columns and on cold delta planes

Then one JSON line summarising every kernel, the card's name and power
limit as nvidia-smi reports them, and the last line
``{"ok": true, "device": {...}}``.  There is no CPU fallback: without a
CUDA device, or when any build, launch or check fails, the script exits
non-zero before the last line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from victoriametrics_tpu_torch import kernels
from victoriametrics_tpu_torch.models import tile_cache
from victoriametrics_tpu_torch.ops import device_decode as dd
from victoriametrics_tpu_torch.ops import device_rollup as dr
from victoriametrics_tpu_torch.ops import decimal as dec
from victoriametrics_tpu_torch.ops.rollup_np import RollupConfig
from victoriametrics_tpu_torch.query import cuda_engine as ce
from victoriametrics_tpu_torch.storage.columnar import PAD_TS, ColumnarSeries
from victoriametrics_tpu_torch.storage.storage import SeriesData
from victoriametrics_tpu_torch.utils import metrics as metricslib

T_START = 1_753_700_000_000   # unix ms of the first scrape
SCRAPE = 15_000
JITTER = 2_000
WINDOW = 300_000
LOOKBACK_DELTA = 300_000

# dashboard: bench.py's headline shape
DASH_SERIES, DASH_SAMPLES, DASH_GROUPS, DASH_STEP = 8192, 1440, 256, 60_000
# (scrapes ingested before the refresh, ms the window advances)
DASH_REFRESHES = [(1, SCRAPE)] * 3 + [(420, 420 * SCRAPE)] + [(1, SCRAPE)] * 2
# full width: BASELINE.md config 2
FULL_SERIES, FULL_PER_GROUP, FULL_STEP = 100_000, 32, 15_000

# H100 SXM (NVIDIA data sheet): HBM3 rate, and the FP64 vector peak, used
# for every scalar operation these kernels do (int32 adds and compares,
# float64 arithmetic)
MEM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 34e12

SOURCES = {
    "decode_tiles": ("victoriametrics_tpu_torch/csrc/decode.cu",
                     "victoriametrics_tpu/ops/device_decode.py:136"),
    "rollup_aggregate_tile": ("victoriametrics_tpu_torch/csrc/rollup.cu",
                              "victoriametrics_tpu/ops/device_rollup.py:750"),
    "append_tile": ("victoriametrics_tpu_torch/csrc/tile.cu",
                    "victoriametrics_tpu/ops/device_rollup.py:784"),
    "compact_tile": ("victoriametrics_tpu_torch/csrc/tile.cu",
                     "victoriametrics_tpu/ops/device_rollup.py:830"),
}


def dashboard_grid() -> tuple[int, int]:
    """(start, end) of the dashboard's first query, as bench.py sets it:
    the end lies beyond every initial sample (jitter included), the range
    spans the history less five minutes."""
    end = T_START + -(-((DASH_SAMPLES - 1) * SCRAPE + JITTER) // DASH_STEP) \
        * DASH_STEP
    return end - ((DASH_SAMPLES - 1) * SCRAPE - 300_000), end


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; phase lines carry the script's elapsed seconds."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10, setup=None) -> float:
    """Median device time of fn() in ms (CUDA events, after one warm-up;
    `setup` runs before each call, outside the timed span)."""
    if setup is not None:
        setup()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| where both are numbers; inf when the NaN
    patterns differ or one side is infinite where the other is not."""
    got, want = got.double(), want.double()
    if got.shape != want.shape or not torch.equal(torch.isnan(got),
                                                  torch.isnan(want)):
        return float("inf")
    same = torch.isnan(got) | (got == want)
    if not bool(torch.isfinite(torch.where(same, 0.0, got - want)).all()):
        return float("inf")
    d = torch.where(same, 0.0, (got - want).abs())
    return float(d.max()) if d.numel() else 0.0


def assert_close(what: str, got, want, rtol: float, atol: float) -> float:
    g = got.double().cpu().numpy() if torch.is_tensor(got) else got
    w = want.double().cpu().numpy() if torch.is_tensor(want) else want
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, equal_nan=True,
                               err_msg=what)
    return max_abs_err(torch.as_tensor(g), torch.as_tensor(w))


def assert_equal(what: str, got: torch.Tensor, want: torch.Tensor) -> float:
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    a, b = got, want
    if got.dtype == torch.float64:  # bit patterns, NaN payloads included
        a, b = got.view(torch.int64), want.view(torch.int64)
    if not torch.equal(a, b):
        raise AssertionError(f"{what}: not bit-identical")
    return 0.0


def aggr_close(what, aggr, got, want) -> float:
    """The tolerance of the port's tests: rtol 1e-12 for the sums and
    extrema; the variance to 1e-9, stddev through its square (see
    tests/test_torch_device_rollup.py)."""
    if aggr == "stddev":
        assert_close(what, got * got, want * want, 1e-9, 1e-9)
        return max_abs_err(got, want)
    if aggr == "stdvar":
        return assert_close(what, got, want, 1e-9, 1e-9)
    return assert_close(what, got, want, 1e-12, 0.0)


# ---------------------------------------------------------------------------
# Workloads, made from the seed with numpy.
# ---------------------------------------------------------------------------

def counters(rng, S: int, N: int, t0: int):
    """S jittered 15 s counters of N samples from t0 (rows stay sorted:
    the jitter is under half the scrape interval)."""
    ts = t0 + np.arange(N, dtype=np.int64)[None, :] * SCRAPE + \
        rng.integers(-JITTER, JITTER + 1, (S, N))
    vals = np.cumsum(rng.integers(0, 50, (S, N)), axis=1).astype(np.float64)
    return ts, vals


def ragged_series(rng):
    """Edge-case rows: single sample, two samples, everything before the
    range, sparse gaps, counter resets, a reset to a negative value, a NaN
    sample, a counter starting at -0.0, plus ordinary counters and
    gauges."""
    out = []
    for i in range(40):
        n = int(rng.integers(3, 200))
        ts = np.sort(T_START + np.arange(n, dtype=np.int64) * SCRAPE +
                     rng.integers(-JITTER, JITTER, n))
        v = np.cumsum(rng.integers(0, 50, n)).astype(np.float64)
        if i % 4 == 1:
            v = np.round(rng.uniform(0, 100, n), 3)
        elif i % 4 == 2:
            for p in rng.integers(1, n, 3):
                v[p:] -= v[p]
            v = np.abs(v)
        elif i % 4 == 3 and n > 10:
            v[n // 2:] -= v[n // 2] + 40.0
        out.append((ts, v))
    out.append((np.array([T_START + 700_000]), np.array([42.0])))
    out.append((np.array([T_START + 700_000, T_START + 710_000]),
                np.array([1.0, 5.0])))
    out.append((np.array([T_START - 50_000]), np.array([7.0])))
    out.append((np.array([T_START, T_START + 900_000, T_START + 1_700_000]),
                np.array([1.0, 100.0, 3.0])))
    ts = T_START + np.arange(150, dtype=np.int64) * SCRAPE
    v = np.cumsum(rng.integers(0, 50, 150)).astype(np.float64)
    v[90] = np.nan
    out.append((ts, v))
    v = np.cumsum(rng.integers(0, 50, 150)).astype(np.float64)
    v[:3] = -0.0
    out.append((ts, v))
    return out


def planes_for(series_tv, start_ms: int, n_cap: int | None = None):
    """(ts, values) series -> delta planes padded to the tile capacity, as
    the engine's cold upload builds them."""
    triples = []
    for ts, v in series_tv:
        m, e = dec.float_to_decimal(v)
        triples.append((ts, m, e))
    planes = dd.pack_delta_planes(triples, start_ms)
    if planes is None:
        raise AssertionError("workload does not fit int32 delta planes")
    n_cap = n_cap or ce.tile_capacity(int(planes.counts.max()))
    pad = max(n_cap - 2 - planes.ts_d2.shape[1], 0)
    planes.ts_d2 = np.pad(planes.ts_d2, ((0, 0), (0, pad)))
    planes.val_d2 = np.pad(planes.val_d2, ((0, 0), (0, pad)))
    return planes, n_cap


def plane_tensors(planes, device):
    return [tile_cache.chunked_device_put(getattr(planes, f), device)
            for f in ("ts_first", "ts_fdelta", "ts_d2", "val_first",
                      "val_fdelta", "val_d2", "scale", "counts")]


class SynthStorage:
    """In-script stand-in for the storage contract advance_rolling reads
    (search_columns, data_version, structural_version,
    min_appended_since, last_partial, dedup_interval_ms): S counters held
    as (S, capacity) host columns that ingest extends one scrape at a time
    per series.  search_columns returns the port's ColumnarSeries."""

    dedup_interval_ms = 0
    last_partial = False
    structural_version = 0

    def __init__(self, rng, S: int, N: int, capacity: int):
        self.rng = rng
        ts, vals = counters(rng, S, N, T_START)
        self.ts = np.full((S, capacity), PAD_TS, dtype=np.int64)
        self.vals = np.zeros((S, capacity), dtype=np.float64)
        self.ts[:, :N] = ts
        self.vals[:, :N] = vals
        self.n = N
        self.raw_names = [b'http_requests_total{instance="host-%d",id="%d"}'
                          % (i % DASH_GROUPS, i) for i in range(S)]
        self.data_version = 1
        self._log = [(1, int(ts.min()))]
        self.fetch_s = 0.0  # time spent answering search_columns

    def ingest(self, k: int, after_ms: int) -> None:
        """k more scrapes per series, 15 s apart, all in (after_ms,
        after_ms + k * 15 s]: strictly newer than anything a query up to
        after_ms has seen."""
        S = self.ts.shape[0]
        ts, incr = counters(self.rng, S, k, after_ms + SCRAPE // 2)
        self.ts[:, self.n:self.n + k] = ts
        self.vals[:, self.n:self.n + k] = \
            self.vals[:, self.n - 1:self.n] + incr
        self.n += k
        self.data_version += 1
        self._log.append((self.data_version, int(ts.min())))

    def min_appended_since(self, version: int):
        lo = [t for v, t in self._log if v > version]
        return min(lo) if lo else None

    def _count_below(self, x: int, strict: bool) -> np.ndarray:
        """Per row, how many of its n samples are < x (strict) or <= x:
        a binary search over all rows at once."""
        lo = np.zeros(self.ts.shape[0], dtype=np.int64)
        hi = np.full(self.ts.shape[0], self.n, dtype=np.int64)
        rows = np.arange(self.ts.shape[0])
        while True:
            open_ = lo < hi
            if not open_.any():
                return lo
            mid = (lo + hi) // 2
            t = self.ts[rows, np.minimum(mid, self.n - 1)]
            below = (t < x) if strict else (t <= x)
            lo = np.where(open_ & below, mid + 1, lo)
            hi = np.where(open_ & ~below, mid, hi)

    def _rows(self, lo: int, hi: int):
        return self._count_below(lo, True), self._count_below(hi, False)

    def search_columns(self, filters, min_ts, max_ts, max_series=None,
                       tenant=None) -> ColumnarSeries:
        t0 = time.perf_counter()
        try:
            return self._columns(min_ts, max_ts)
        finally:
            self.fetch_s += time.perf_counter() - t0

    def _columns(self, min_ts, max_ts) -> ColumnarSeries:
        a, b = self._rows(min_ts, max_ts)
        cnt = b - a
        keep = np.flatnonzero(cnt > 0)
        if not keep.size:
            return ColumnarSeries.empty()
        a, cnt = a[keep], cnt[keep]
        K = int(cnt.max())
        idx = np.minimum(a[:, None] + np.arange(K)[None, :],
                         self.ts.shape[1] - 1)
        live = np.arange(K)[None, :] < cnt[:, None]
        rows = keep[:, None]
        ts = np.where(live, self.ts[rows, idx], PAD_TS)
        vals = np.where(live, self.vals[rows, idx], 0.0)
        return ColumnarSeries(keep.astype(np.int64), ts, vals,
                              cnt.astype(np.int64),
                              raw_names=[self.raw_names[i] for i in keep])

    def search_series(self, min_ts: int, max_ts: int) -> list[SeriesData]:
        a, b = self._rows(min_ts, max_ts)
        return [SeriesData(None, self.ts[i, a[i]:b[i]].copy(),
                           self.vals[i, a[i]:b[i]].copy(),
                           raw_name=self.raw_names[i])
                for i in range(self.ts.shape[0]) if b[i] > a[i]]


def upload_paths(what: str, arrays, dev, reps: int = 5) -> dict:
    """Host wall ms to put `arrays` on the card through each of the tile
    cache's two paths, pinned-staged and direct: medians of `reps`
    alternating rounds after one checked warm-up round each."""
    paths = {"staged": tile_cache.staged_put, "direct": tile_cache.direct_put}

    def put_all(put):
        t0 = time.perf_counter()
        out = [put(a, dev) for a in arrays]
        torch.cuda.synchronize(dev)
        return time.perf_counter() - t0, out

    for name, put in paths.items():
        for a, t in zip(arrays, put_all(put)[1]):
            if not torch.equal(t.cpu(), torch.from_numpy(a)):
                raise AssertionError(f"{what}: {name} upload differs")
    times = {name: [] for name in paths}
    for _ in range(reps):
        for name, put in paths.items():
            times[name].append(put_all(put)[0])
    return {"what": what, "arrays": len(arrays),
            "bytes": int(sum(a.nbytes for a in arrays)),
            "largest_array_bytes": int(max(a.nbytes for a in arrays)),
            **{f"{name}_ms": float(np.median(t)) * 1e3
               for name, t in times.items()}}


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------

def phase_kernels(rng, dev) -> dict:
    """Each kernel against its plain version on the card: the dashboard
    shapes (timed) and ragged edge-case rows."""
    res = {}
    # dashboard-shape inputs, the same generator the dashboard phase uses
    ts_h, vals_h = counters(rng, DASH_SERIES, DASH_SAMPLES, T_START)
    planes, n_cap = planes_for(zip(ts_h, vals_h), dashboard_grid()[0])
    args = plane_tensors(planes, dev)
    # K1
    got = dd.decode_tiles(*args, n_cap)
    want = dd.decode_tiles_plain(*args, n_cap)
    assert_equal("K1 ts", got[0], want[0])
    assert_equal("K1 values", got[1], want[1])
    for jitter, incr in ((20, 30), (2_000, 5_000), (100_000, 2_000_000)):
        edge = []
        for i in range(64):
            n = 1 + i * 3
            t = np.sort(T_START + np.arange(n) * SCRAPE +
                        rng.integers(-jitter, jitter + 1, n))
            edge.append((t, np.cumsum(rng.integers(0, incr + 1, n)) / 100.0))
        p, nc = planes_for(edge, T_START)
        a = plane_tensors(p, dev)
        g, w = dd.decode_tiles(*a, nc), dd.decode_tiles_plain(*a, nc)
        assert_equal(f"K1 ts edge {p.ts_d2.dtype}", g[0], w[0])
        assert_equal(f"K1 values edge {p.val_d2.dtype}", g[1], w[1])
    in_bytes = sum(t.numel() * t.element_size() for t in args)
    out_bytes = DASH_SERIES * n_cap * 12
    res["decode_tiles"] = dict(
        max_abs_err=0.0,  # bit-identical, checked above
        ms=cuda_ms(lambda: dd.decode_tiles(*args, n_cap)),
        plain_ms=cuda_ms(lambda: dd.decode_tiles_plain(*args, n_cap)),
        bytes=in_bytes + out_bytes, ops=2 * 2 * DASH_SERIES * n_cap)
    ts_t, v_t = got
    counts = args[7]

    # K2 at the dashboard shape: the cold query's launch, and a rolling
    # refresh's (grid advanced one scrape, the fetch bound gating)
    start, end = dashboard_grid()
    cfg = dr.normalized_cfg("rate", RollupConfig(start, end, DASH_STEP,
                                                 WINDOW))
    gids = (np.arange(DASH_SERIES) % DASH_GROUPS).astype(np.int32)
    groups = dr.group_layout(gids, DASH_GROUPS, dev)
    k2 = lambda: dr.rollup_aggregate_tile(  # noqa: E731
        "rate", "sum", ts_t, v_t, counts, groups, cfg)
    k2_plain = lambda: dr.rollup_aggregate_tile_plain(  # noqa: E731
        "rate", "sum", ts_t, v_t, counts, groups, cfg)
    out = k2()
    err2 = aggr_close("K2 dashboard", "sum", out, k2_plain())
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("K2 dashboard: non-finite group rates")
    # the same tile with a counter reset halfway along every 64th row and
    # a -0.0 on row 1: those rows take K2's scratch path, the rest read
    # the values directly
    rows = torch.arange(0, DASH_SERIES, 64, device=dev)
    mid = (counts[rows].long() // 2)[:, None]
    cols = torch.arange(n_cap, device=dev)[None, :]
    v_reset = v_t.clone()
    v_reset[rows] = torch.where(cols >= mid, v_t[rows] - v_t[rows].gather(
        1, mid), v_t[rows])
    v_reset[1, 0] = -0.0
    k2_resets = lambda: dr.rollup_aggregate_tile(  # noqa: E731
        "rate", "sum", ts_t, v_reset, counts, groups, cfg)
    err2 = max(err2, aggr_close(
        "K2 dashboard with resets", "sum", k2_resets(),
        dr.rollup_aggregate_tile_plain("rate", "sum", ts_t, v_reset, counts,
                                       groups, cfg)))
    roll = (SCRAPE, -(WINDOW + LOOKBACK_DELTA))
    err2 = max(err2, aggr_close(
        "K2 dashboard rolling", "sum",
        dr.rollup_aggregate_tile("rate", "sum", ts_t, v_t, counts, groups,
                                 cfg, *roll),
        dr.rollup_aggregate_tile_plain("rate", "sum", ts_t, v_t, counts,
                                       groups, cfg, *roll)))
    # every func x aggregate on the ragged rows, plain and shifted grids
    ragged = ragged_series(rng)
    rcfg0 = RollupConfig(T_START + 600_000, T_START + 1_800_000, 60_000,
                         WINDOW)
    rg = (np.arange(len(ragged)) * 7 % 4).astype(np.int32)
    rgroups = dr.group_layout(rg, 5, dev)
    for off, mt in ((0, int(dr.MIN_TS_NONE)), (120_000, -420_000)):
        tsr, vr, cr = (torch.from_numpy(a).to(dev) for a in dr.pack_series(
            ragged, rcfg0.start - off))
        for func in dr.FUSED_FUNCS:
            rcfg = dr.normalized_cfg(func, rcfg0)
            for aggr in dr.AGGR_FUNCS:
                g = dr.rollup_aggregate_tile(func, aggr, tsr, vr, cr,
                                             rgroups, rcfg, off, mt)
                w = dr.rollup_aggregate_tile_plain(func, aggr, tsr, vr, cr,
                                                   rgroups, rcfg, off, mt)
                if not bool(torch.isnan(g[4]).all()):
                    raise AssertionError("K2: the empty group is not NaN")
                e = aggr_close(f"K2 {func}/{aggr} shift {off}", aggr, g, w)
                if aggr != "stddev":
                    err2 = max(err2, e)
    T = dr.num_steps(cfg)
    n_valid = int(counts.sum())
    res["rollup_aggregate_tile"] = dict(
        max_abs_err=err2, ms=cuda_ms(k2), plain_ms=cuda_ms(k2_plain, reps=3),
        ms_with_resets=cuda_ms(k2_resets),
        bytes=n_valid * 12 + DASH_SERIES * 12 + DASH_GROUPS * T * 8,
        ops=15 * DASH_SERIES * T)

    # K3: one new scrape per series, K padded to 8 as _append_cols does
    K = 8
    new_ts = (ts_t.gather(1, (counts.long() - 1)[:, None]) + SCRAPE +
              torch.arange(K, device=dev, dtype=torch.int32)[None, :]
              * SCRAPE).to(torch.int32).contiguous()
    new_vals = torch.rand((DASH_SERIES, K), dtype=torch.float64, device=dev,
                          generator=torch.Generator(dev).manual_seed(1))
    new_counts = torch.ones(DASH_SERIES, dtype=torch.int32, device=dev)
    bufs = {}

    def fresh():
        for name, t in (("ts", ts_t), ("v", v_t), ("c", counts)):
            if name not in bufs:
                bufs[name] = torch.empty_like(t)
            bufs[name].copy_(t)

    def k3():
        dr.append_tile(bufs["ts"], bufs["v"], bufs["c"], new_ts, new_vals,
                       new_counts)

    fresh()
    k3()
    got = [bufs[k].clone() for k in ("ts", "v", "c")]
    plain = [t.clone() for t in (ts_t, v_t, counts)]
    dr.append_tile_plain(*plain, new_ts, new_vals, new_counts)
    for g, w, what in zip(got, plain, ("ts", "values", "counts")):
        assert_equal(f"K3 {what}", g, w)
    # edge rows: counts near the capacity, zero and full new counts
    ec = torch.randint(n_cap - 12, n_cap + 1, (DASH_SERIES,), device=dev,
                       dtype=torch.int32,
                       generator=torch.Generator(dev).manual_seed(2))
    enc = torch.randint(0, K + 1, (DASH_SERIES,), device=dev,
                        dtype=torch.int32,
                        generator=torch.Generator(dev).manual_seed(3))
    a = [ts_t.clone(), v_t.clone(), ec.clone()]
    b = [ts_t.clone(), v_t.clone(), ec.clone()]
    dr.append_tile(*a, new_ts, new_vals, enc)
    dr.append_tile_plain(*b, new_ts, new_vals, enc)
    for g, w, what in zip(a, b, ("ts", "values", "counts")):
        assert_equal(f"K3 edge {what}", g, w)
    # bytes the function needs: each live new sample read and written
    # (12 B each way), counts read and written, new_counts read; the padded
    # columns past new_counts are never touched
    n_new = int(new_counts.sum())
    res["append_tile"] = dict(
        max_abs_err=0.0, ms=cuda_ms(k3, setup=fresh),
        plain_ms=cuda_ms(lambda: dr.append_tile_plain(
            bufs["ts"], bufs["v"], bufs["c"], new_ts, new_vals, new_counts),
            setup=fresh),
        bytes=n_new * 12 * 2 + DASH_SERIES * 12, ops=n_new)

    uploads = [
        upload_paths("refresh_columns", [new_ts.cpu().numpy(),
                                         new_vals.cpu().numpy(),
                                         new_counts.cpu().numpy()], dev),
        upload_paths("dashboard_planes", [
            getattr(planes, f) for f in ("ts_first", "ts_fdelta", "ts_d2",
                                         "val_first", "val_fdelta", "val_d2",
                                         "scale", "counts")], dev)]

    # K4: the resume refresh's slide (drops ~105 minutes of samples)
    cutoff = 420 * SCRAPE + 45_000
    for c in (cutoff, 0, 2**31 - 2):
        g = dr.compact_tile(ts_t, v_t, counts, c, c)
        w = dr.compact_tile_plain(ts_t, v_t, counts, c, c)
        for x, y, what in zip(g, w, ("ts", "values", "counts")):
            assert_equal(f"K4 {what} cutoff {c}", x, y)
    # bytes the function needs: each survivor read (12 B), only the
    # timestamp of each dropped sample (4 B), the whole [S, N] output
    # written (12 B per column), counts read and written
    survivors = int(dr.compact_tile_plain(ts_t, v_t, counts, cutoff,
                                          cutoff)[2].sum())
    dropped = n_valid - survivors
    res["compact_tile"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: dr.compact_tile(ts_t, v_t, counts, cutoff,
                                           cutoff)),
        plain_ms=cuda_ms(lambda: dr.compact_tile_plain(ts_t, v_t, counts,
                                                       cutoff, cutoff)),
        bytes=survivors * 12 + dropped * 4 + DASH_SERIES * n_cap * 12 +
        DASH_SERIES * 8,
        ops=DASH_SERIES * n_cap)
    for r in res.values():
        r["bound_ms"] = max(r["bytes"] / MEM_BYTES_PER_S,
                            r["ops"] / SCALAR_OPS_PER_S) * 1e3
        r["bound_by"] = "bytes" if r["bytes"] / MEM_BYTES_PER_S >= \
            r["ops"] / SCALAR_OPS_PER_S else "operations"
    emit({"phase": "kernels", "ok": True,
          "shapes": {"series": DASH_SERIES, "tile_cols": n_cap,
                     "steps": T, "groups": DASH_GROUPS},
          "kernels": res, "uploads": uploads})
    return res


def _metric_sum(name: str) -> float:
    return float(sum(v for k, v in metricslib.REGISTRY.snapshot().items()
                     if k.startswith(name)))


# where a query's wall time goes: the engine's own transfer and kernel
# timers (each kernel call is timed to its completion on the card)
SPLIT = {
    "h2d": 'vm_device_transfer_duration_seconds_sum{span="device:upload"}',
    "d2h": 'vm_device_transfer_duration_seconds_sum{span="device:download"}',
    "k1": 'vm_tpu_kernel_duration_seconds_sum{kernel="decode_tiles"',
    "k2": 'vm_tpu_kernel_duration_seconds_sum{kernel="rollup_aggregate_tile"',
    "k3": 'vm_tpu_kernel_duration_seconds_sum{kernel="append_tile"',
    "k4": 'vm_tpu_kernel_duration_seconds_sum{kernel="compact_tile"',
}


def split_snapshot() -> dict[str, float]:
    return {k: _metric_sum(n) for k, n in SPLIT.items()}


def split_ms(before: dict, after: dict, wall_s: float,
             extra: dict | None = None) -> dict[str, float]:
    """Per-layer ms between two snapshots; `host_ms` is the rest of the
    wall time (host packing and glue), `kernel_share` the kernels' part of
    the wall time (an upper bound on the card's busy share: each kernel
    call is timed from its launch to its completion)."""
    out = {f"{k}_ms": (after[k] - before[k]) * 1e3 for k in SPLIT}
    for k, v in (extra or {}).items():
        out[f"{k}_ms"] = v * 1e3
    out["host_ms"] = wall_s * 1e3 - sum(out.values())
    out["kernel_share"] = sum(after[k] - before[k] for k in
                              ("k1", "k2", "k3", "k4")) / wall_s
    return out


def phase_dashboard(rng, dev) -> dict:
    """The main path: cold query, then rolling refreshes, each held
    against a cold rebuild."""
    S, G = DASH_SERIES, DASH_GROUPS
    extra = sum(k for k, _ in DASH_REFRESHES)
    store = SynthStorage(rng, S, DASH_SAMPLES, DASH_SAMPLES + extra)
    gids = (np.arange(S) % G).astype(np.int32)
    start, end = dashboard_grid()
    fetch_lo = start - WINDOW - LOOKBACK_DELTA
    engine = ce.CUDAEngine(device=dev)
    kernels.reset_launches()
    rebuild_launches = {}

    def cold(start_ms, end_ms, eng, key=None):
        series = store.search_series(start_ms - WINDOW - LOOKBACK_DELTA,
                                     end_ms)
        cfg = RollupConfig(start_ms, end_ms, DASH_STEP, WINDOW)
        return ce.try_aggr_rollup(eng, "sum", "rate", series, gids, G, cfg,
                                  cache_key=key), series

    ver0 = store.data_version
    up0 = tile_cache.bytes_uploaded()
    snap = split_snapshot()
    t0 = time.perf_counter()
    key = ("dashboard", start, ver0)
    out, series = cold(start, end, engine, key)
    cold_s = time.perf_counter() - t0
    cold_ms = cold_s * 1e3
    cold_split = split_ms(snap, split_snapshot(), cold_s)
    cold_up = tile_cache.bytes_uploaded() - up0
    T = (end - start) // DASH_STEP + 1
    if out is None or out.shape != (G, T) or not np.isfinite(out).all():
        raise AssertionError("dashboard cold query: wrong or non-finite "
                             "result")
    tiles = engine.cache().get(key)
    rt = ce.RollingTile(
        tiles=tiles, base_ms=start, n_cap=int(tiles[0].shape[1]),
        lo_ms=fetch_lo, hi_ms=end, version=ver0,
        structural=store.structural_version,
        counts_host=np.array([sd.timestamps.size for sd in series],
                             np.int64),
        row_of_raw={sd.raw_name: i for i, sd in enumerate(series)},
        n_samples=sum(sd.timestamps.size for sd in series), adopted_key=key)
    groups = dr.group_layout(gids, G, dev)
    engine.window_cache().put(("dashboard", "sum", "rate"), (rt, groups))
    refresh_ms, refresh_up, refresh_split, worst = [], [], [], 0.0
    compactions0 = _metric_sum("vm_device_window_compactions_total")
    for k, adv in DASH_REFRESHES:
        store.ingest(k, end)
        start, end = start + adv, end + adv
        fetch_lo = start - WINDOW - LOOKBACK_DELTA
        up0 = tile_cache.bytes_uploaded()
        snap, fetch0 = split_snapshot(), store.fetch_s
        t0 = time.perf_counter()
        rt, groups = engine.window_cache().get(("dashboard", "sum", "rate"))
        if not ce.advance_rolling(engine, rt, store, None, start, fetch_lo,
                                  end, None, None, True):
            raise AssertionError("rolling refresh declined: "
                                 + engine.last_roll_decline)
        cfg = RollupConfig(start, end, DASH_STEP, WINDOW)
        served = ce.run_fused_on_tiles(engine, "sum", "rate", rt.tiles,
                                       groups, cfg, start - rt.base_ms,
                                       fetch_lo - start)
        wall = time.perf_counter() - t0
        refresh_ms.append(wall * 1e3)
        refresh_up.append(tile_cache.bytes_uploaded() - up0)
        refresh_split.append(split_ms(snap, split_snapshot(), wall,
                                      {"fetch": store.fetch_s - fetch0}))
        tile_cache.count_window_hit()
        before = dict(kernels.LAUNCHES)
        rebuilt, _ = cold(start, end, ce.CUDAEngine(device=dev))
        for name, n in kernels.LAUNCHES.items():
            rebuild_launches[name] = rebuild_launches.get(name, 0) + \
                n - before.get(name, 0)
        worst = max(worst, assert_close("served == cold", served, rebuilt,
                                        1e-12, 0.0))
    launches = {name: kernels.LAUNCHES.get(name, 0) -
                rebuild_launches.get(name, 0) for name in SOURCES}
    compactions = _metric_sum("vm_device_window_compactions_total") - \
        compactions0
    steady = [u for (k, _), u in zip(DASH_REFRESHES, refresh_up) if k == 1]
    if compactions < 1:
        raise AssertionError("no refresh slid the window (compact_window)")
    if max(steady) * 20 > cold_up:
        raise AssertionError("steady refreshes uploaded too much")
    res = {"phase": "dashboard", "ok": True, "series": S, "groups": G,
           "steps": T, "cold_ms": cold_ms, "cold_upload_bytes": cold_up,
           "cold_split": cold_split,
           "refresh_ms": refresh_ms, "refresh_upload_bytes": refresh_up,
           "refresh_split": refresh_split,
           "refresh_scrapes": [k for k, _ in DASH_REFRESHES],
           "compactions": compactions, "appends": rt.appends,
           "served_vs_cold_max_abs_err": worst, "launches": launches}
    emit(res)
    return res


def phase_full_width(rng, dev, hours: float) -> dict:
    """BASELINE config 2 as one cold query, with its time split."""
    S, G = FULL_SERIES, FULL_SERIES // FULL_PER_GROUP
    N = int(hours * 3600_000 // SCRAPE)
    if hours != 24:
        print(json.dumps({"cut": {"full_width_hours": hours,
                                  "reference_hours": 24}}), flush=True)
    t0 = time.perf_counter()
    ts, vals = counters(rng, S, N, T_START)
    series = [SeriesData(None, ts[i], vals[i], raw_name=b"c%d" % i)
              for i in range(S)]
    gen_s = time.perf_counter() - t0
    gids = (np.arange(S) % G).astype(np.int32)
    cfg = RollupConfig(T_START, T_START + N * SCRAPE, FULL_STEP, WINDOW)
    engine = ce.CUDAEngine(device=dev, cache_bytes=64 << 30)
    key = ("full_width",)
    up0 = tile_cache.bytes_uploaded()
    torch.cuda.reset_peak_memory_stats(dev)
    # keep the planes the engine hands K1, to hold K1 against its plain
    # version afterwards (the wrapper itself runs and counts as always)
    planes = []
    decode = dd.decode_tiles

    def decode_tap(*a):
        planes.append(a)
        return decode(*a)

    dd.decode_tiles = decode_tap
    snap = split_snapshot()
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        out = ce.try_aggr_rollup(engine, "sum", "rate", series, gids, G, cfg,
                                 cache_key=key)
    finally:
        dd.decode_tiles = decode
    total = time.perf_counter() - t0
    launches = {name: kernels.LAUNCHES.get(name, 0) for name in SOURCES}
    split = split_ms(snap, split_snapshot(), total)
    peak = torch.cuda.max_memory_allocated(dev)
    T = dr.num_steps(cfg)
    if out is None or out.shape != (G, T):
        raise AssertionError("full width: wrong result shape")
    if not np.isfinite(out[:, WINDOW // FULL_STEP + 1:]).all():
        raise AssertionError("full width: non-finite group rates")
    if launches["decode_tiles"] < 1 or launches["rollup_aggregate_tile"] < 1:
        raise AssertionError(f"full width: K1/K2 not launched: {launches}")
    ts_t, v_t, counts = engine.cache().get(key)
    # K1 against its plain version, bit for bit, in row chunks
    args, n_cap = planes[0][:8], planes[0][8]
    chunk = 4096
    for r0 in range(0, S, chunk):
        w_ts, w_v = dd.decode_tiles_plain(
            *(a[r0:r0 + chunk] for a in args), n_cap)
        assert_equal(f"full width K1 ts rows {r0}+", ts_t[r0:r0 + chunk],
                     w_ts)
        assert_equal(f"full width K1 values rows {r0}+", v_t[r0:r0 + chunk],
                     w_v)
        del w_ts, w_v
    uploads = upload_paths(
        "full_width_planes", [a.cpu().numpy() for a in args], dev, reps=3)
    del planes, args
    groups = dr.group_layout(gids, G, dev)
    ncfg = dr.normalized_cfg("rate", cfg)
    k2_ms = cuda_ms(lambda: dr.rollup_aggregate_tile(
        "rate", "sum", ts_t, v_t, counts, groups, ncfg), reps=3)
    # plain version in row chunks: per-chunk rollup, summed by group
    cnt = torch.zeros((G, T), dtype=torch.float64, device=dev)
    s1 = torch.zeros_like(cnt)
    for r0 in range(0, S, chunk):
        sl = slice(r0, r0 + chunk)
        rolled = dr.rollup_tile("rate", ts_t[sl], v_t[sl], counts[sl], ncfg)
        present = ~torch.isnan(rolled)
        g = groups.gids[sl].long()
        cnt.index_add_(0, g, present.double())
        s1.index_add_(0, g, torch.where(present, rolled, 0.0))
        del rolled, present
    plain = torch.where(cnt > 0, s1, torch.nan)
    err = assert_close("full width K2 vs plain", torch.from_numpy(out),
                       plain.cpu(), 1e-12, 0.0)
    res = {"phase": "full_width", "ok": True, "series": S, "groups": G,
           "samples_per_series": N, "hours": hours, "steps": T,
           "tile_cols": int(ts_t.shape[1]),
           "tile_bytes": int(ts_t.numel() * 12),
           "upload_bytes": tile_cache.bytes_uploaded() - up0,
           "generate_s": gen_s, "total_ms": total * 1e3, "split": split,
           "k2_event_ms": k2_ms,
           "k2_bound_ms": (int(counts.sum()) * 12 + S * 12 + G * T * 8) /
           MEM_BYTES_PER_S * 1e3,
           "peak_device_bytes": peak, "launches": launches,
           "k1_bitwise_vs_plain": True, "max_abs_err_vs_plain": err,
           "uploads": uploads}
    emit(res)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="numpy seed of every workload")
    ap.add_argument("--full-hours", type=float, default=24.0,
                    help="hours of history in the full_width phase (cut "
                    "only this, never series, groups, step or window)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gpu = gpu_line()
    t0 = time.perf_counter()
    build_s = kernels.build()
    for name in kernels.SOURCES:
        kernels.lib(name)
    emit({"phase": "build", "ok": True, "seconds": build_s,
          "load_seconds": time.perf_counter() - t0, "gpu": gpu,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    rng = np.random.default_rng(args.seed)
    kres = phase_kernels(rng, dev)
    dash = phase_dashboard(rng, dev)
    for name, n in dash["launches"].items():
        if n < 1:
            raise AssertionError(f"{name} never launched on the main path")
    phase_full_width(rng, dev, args.full_hours)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": dash["launches"][name],
         "max_abs_err": kres[name]["max_abs_err"], "ms": kres[name]["ms"],
         "plain_ms": kres[name]["plain_ms"],
         "bound_ms": kres[name]["bound_ms"],
         "bound_by": kres[name]["bound_by"], "library_ms": None}
        for name in SOURCES]})
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
