#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's device query engine on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--full-hours H]

Runs only the port (``victoriametrics_tpu_torch``), never JAX.  Phases,
each printing one JSON line:

  build       compile csrc/*.cu with nvcc for sm_90a, one process per
              source, all started together
  kernels     K1 decode_tiles (also at its edge rows: n of 1, 2 and odd
              widths, each d2 width, planes wider than n - 2 or at an
              offset from a 16-byte word, count-0 rows, wrapping tails,
              rows cut in chunks), K2
              rollup_aggregate_tile, K3 append_tile,
              K4 compact_tile, B5 rollup_tile, B6 topk_select_tile and
              take_rows, B7 rank_tile and B8 rollup_quantile_tile against
              their plain PyTorch versions on the card: every rollup func
              (K2 under every aggregate) on ragged edge-case rows and the
              dashboard tile, shifted and not, B5 on its plan's path
              (staged) also against its global search bit for bit; B6 at
              k in {1, 10, 16, 17,
              K_REG, K_REG + 1, S} (both of its paths and their
              boundaries) on the dashboard, ragged, tie and tall tiles,
              take_rows with int32 and int64 indices (out-of-range ones
              among them), every rank kind (and a tile wider than the
              kernels' shared-memory staging, and B7's edge rows at step
              counts on and around each median path's limits: no live
              step, one, two, ties straddling the median, signed zeros
              at j0 and j1, infinities, constant rows), every quantile
              phi at
              groups of 32 and of all rows, on rates and on a tile of
              ties, and on B8's cluster and block paths at their edges
              (one group of 100,000 rows, groups at and above what a
              cluster and a block stage, one that no cluster divides,
              an all-NaN group and one with a single live row); times
              each with CUDA events beside its plain version
              and, where one PyTorch call computes the same function, that
              call (B6 and take_rows and their library calls three ways:
              events around one call, around back-to-back calls, and the
              wrapper's host time; B8 and torch.nanquantile also so, and
              K2 over one group of the dashboard tile); K2's count,
              group, min and max of rate (with resets too) and deriv,
              plain and rolling, equal to B5's rows under the plain
              aggregate; K2 over one group of the dashboard tile and over
              groups of exactly R, R + 1 and 2R + 1 members (R =
              FLEET_CHUNK), every aggregate (count, group, min and max
              against B5's rows, the rest against the chunked plain
              version); B9
              fleet_rollup_aggregate_tile, B10
              fleet_append_tile (at K 8, 16 and 24 and at the resume's
              K 120) and
              B11 fleet_compact_tile at a fleet
              bucket's shape (nine live streams of the dashboard tile with
              their own shifts, fetch bounds and the eight aggregates
              mixed, three padded slots, padded rows and groups), B9 also
              over groups it walks in chunks, its count, group, min and
              max against K2 on each stream bit for bit (whether the
              other aggregates come out bit for bit too is recorded);
              B12
              decode_and_rollup (every func, shared-memory and scratch
              rows), B13
              sharded_rollup_aggregate (every func and aggregate on 8
              logical shards, by instance and in one group; its moments
              bit for bit against a sequential walk of B5's rows, the
              8 shards one launch), B14 cached_fleet_rollup_aggregate (both
              fleet buckets, bit for bit against B9) and B15
              time_sharded_rollup (every func but lifetime, and at a halo
              as wide as a shard, with gaps in the first time shard and in
              a halo; its halo pass row by row against the plain
              compaction, rows read in place and compacted rows both;
              one launch per phase for the card's 8 shards and at most
              one host sync), each against its plain version and against
              the unsharded kernels
  dashboard   the main path: a cold ``sum by (instance)(rate(m[5m]))``
              over 8192 counters x 6 h at 15 s (256 instances, step 60 s),
              then the other panels on its resident tile (per-series
              rate, topk/bottomk(10), topk_avg/median/last(10),
              quantile(0.9) by instance, median without by), each held
              against the same entry point on a CPU engine; then 6
              rolling refreshes through advance_rolling and
              run_fused_on_tiles with new scrapes ingested in between
              (one refresh resumes after a long pause and slides the
              window with compact_window), each followed by the quantile
              panel through run_quantile_on_tiles; every refresh is held
              against a cold rebuild at rtol 1e-12
  fleet       fleet-batched serving on the dashboard's store and resident
              selector: 128 standing queries ({rate, increase, irate,
              max_over_time} x the 8 aggregates x {by instance, no
              grouping} x two grids) adopted into 16 buckets, then six
              intervals through FleetPlane.run (one B9 launch per bucket,
              B10 appends, B11 slides at a 30-minute resume), every
              stream of every interval held against the per-stream path
              (advance_rolling + run_fused_on_tiles) at rtol 1e-12
  full_width  BASELINE config 2: 100,000 counters x 24 h at 15 s, 32
              series per instance, step 15 s, window 5 m, as one cold
              query with its own launch counts; K1 and K2 are checked
              against their plain versions in row chunks (K1's device ms
              on the query's planes recorded), and K2's count,
              group, min and max of rate and deriv against B5's rows
              under the plain aggregate; B5's staged rate, deriv and
              tlast_over_time against its global search bit for bit, in
              row chunks, both paths timed; then, on the
              resident tile, topk(10, rate), topk_median(10, rate),
              avg by (instance)(deriv) and an instant quantile(0.99, rate)
              over every series, each with its launch counts and checked
              against the plain versions (B8's instant at every phi on its
              cluster path, timed three ways beside torch.nanquantile;
              B6 also at k = 20 and, its sort
              path, at K_REG + 1 on a 512-step slice; B7's five kinds in
              row chunks, avg beside torch.nanmean); the library calls
              beside B6-B8 (torch.topk, torch.index_select,
              torch.nanquantile) at this width; a range quantile at this
              width is declined by the dense-budget gate, as in the
              reference
  mesh        the multi-device paths on 8 logical shards of this card
              (every shard on cuda:0): (a) the dashboard through
              CUDAEngine(mesh=make_mesh(8, 1)): the cold query (K1 per
              shard, B13 sharded_rollup_aggregate) and the six refreshes
              (K3 per shard, K4 at the resume), every aggregate held
              against the unsharded engine (count, group, min and max bit
              for bit, sum and avg at rtol 1e-12, stddev and stdvar at the
              tests' allowances) and each served result against its own
              cold rebuild; (b) the full-width cold query through the
              sharded engine, held against the full_width phase's K2 the
              same way; (c) B15 time_sharded_rollup on a (2, 4) mesh over
              the full-width tile's columns, against B5 at 1e-9, each call
              one launch per phase; (d) B14:
              16 standing queries in 2 buckets of 8 on an 8-way stream
              mesh, against the same streams on an unsharded fleet, bit
              for bit; (e) B12 decode_and_rollup on the dashboard's and
              the full width's delta planes, against K1 -> B5 bit for bit
              and against its plain version, timed beside K1 -> B5
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
import collections
import contextlib
import copy
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
from victoriametrics_tpu_torch.parallel import mesh as meshlib
from victoriametrics_tpu_torch.parallel.partition import split_rows
from victoriametrics_tpu_torch.query import cuda_engine as ce
from victoriametrics_tpu_torch.query import fleet
from victoriametrics_tpu_torch.storage.columnar import PAD_TS, ColumnarSeries
from victoriametrics_tpu_torch.storage.storage import SeriesData
from victoriametrics_tpu_torch.timing import (
    MEM_BYTES_PER_S, SCALAR_OPS_PER_S, bound, cuda_ms, device_ms,
    fleet_bound, library_or_oom, quantile_bound, take_rows_bound, three_ms,
    topk_bound)
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
# the dashboard's selector and its roll-state keys
SELECTOR = "http_requests_total"
# fleet: the standing queries' funcs, and their grids as (duration, step,
# groupings): A the dashboard panel's range on its 60 s step (5 h 54 m:
# its tile, slid at the resume refresh, holds no longer history), B the
# last hour at the scrape interval.  The roll-state key that names a fleet
# member carries no grid or window (the reference's), so one expression on
# two grids would share one member: B's panels group with `without`, the
# same groups written as expressions of their own
FLEET_FUNCS = ("rate", "increase", "irate", "max_over_time")
FLEET_GRIDS = {
    "A": (354 * 60_000, 60_000, ((("instance",), False), ((), False))),
    "B": (3_600_000, SCRAPE, ((("id",), True), (("instance", "id"), True)))}
# (scrapes per series ingested before the interval, ms the clock advances):
# five steady minutes, then a resume after 30 minutes that overruns grid
# B's column headroom (B11) and not grid A's
FLEET_INTERVALS = [(4, 60_000)] * 5 + [(120, 1_800_000)]
# the phase's bucket shape in the kernels phase: slots, live streams,
# columns, steps
FLEET_B, FLEET_LIVE, FLEET_N, FLEET_T = 12, 9, 2048, 384

SOURCES = {
    "decode_tiles": ("victoriametrics_tpu_torch/csrc/decode.cu",
                     "victoriametrics_tpu/ops/device_decode.py:136"),
    "rollup_aggregate_tile": ("victoriametrics_tpu_torch/csrc/rollup.cu",
                              "victoriametrics_tpu/ops/device_rollup.py:750"),
    "append_tile": ("victoriametrics_tpu_torch/csrc/tile.cu",
                    "victoriametrics_tpu/ops/device_rollup.py:784"),
    "compact_tile": ("victoriametrics_tpu_torch/csrc/tile.cu",
                     "victoriametrics_tpu/ops/device_rollup.py:830"),
    "rollup_tile": ("victoriametrics_tpu_torch/csrc/rollup.cu",
                    "victoriametrics_tpu/ops/device_rollup.py:300"),
    "topk_select_tile": ("victoriametrics_tpu_torch/csrc/select.cu",
                         "victoriametrics_tpu/ops/device_rollup.py:887"),
    "take_rows": ("victoriametrics_tpu_torch/csrc/select.cu",
                  "victoriametrics_tpu/ops/device_rollup.py:939"),
    "rank_tile": ("victoriametrics_tpu_torch/csrc/select.cu",
                  "victoriametrics_tpu/ops/device_rollup.py:904"),
    "rollup_quantile_tile": ("victoriametrics_tpu_torch/csrc/quantile.cu",
                             "victoriametrics_tpu/ops/device_rollup.py:948"),
    "fleet_rollup_aggregate_tile": (
        "victoriametrics_tpu_torch/csrc/rollup.cu",
        "victoriametrics_tpu/ops/device_rollup.py:737"),
    "fleet_append_tile": ("victoriametrics_tpu_torch/csrc/tile.cu",
                          "victoriametrics_tpu/ops/device_rollup.py:800"),
    "fleet_compact_tile": ("victoriametrics_tpu_torch/csrc/tile.cu",
                           "victoriametrics_tpu/ops/device_rollup.py:851"),
    "decode_and_rollup": ("victoriametrics_tpu_torch/csrc/rollup.cu",
                          "victoriametrics_tpu/ops/device_decode.py:157"),
    "sharded_rollup_aggregate": ("victoriametrics_tpu_torch/csrc/mesh.cu",
                                 "victoriametrics_tpu/parallel/mesh.py:103"),
    "cached_fleet_rollup_aggregate": (
        "victoriametrics_tpu_torch/csrc/rollup.cu",
        "victoriametrics_tpu/parallel/mesh.py:68"),
    "time_sharded_rollup": ("victoriametrics_tpu_torch/csrc/mesh.cu",
                            "victoriametrics_tpu/parallel/mesh.py:141"),
}
#: the fleet phase's kernels, whose launches count on its own path
FLEET_KERNELS = ("fleet_rollup_aggregate_tile", "fleet_append_tile",
                 "fleet_compact_tile")
#: the mesh phase's kernels, whose launches count on its own path
MESH_KERNELS = ("decode_and_rollup", "sharded_rollup_aggregate",
                "cached_fleet_rollup_aggregate", "time_sharded_rollup")
# the mesh phase: logical shards of the card, B15's (series, time) mesh,
# step and halo (>= window / scrape + 2 samples), and the fleet part's
# intervals: two steady minutes, then the 30-minute resume that slides
# grid B's windows (B11 per shard)
MESH_SHARDS = 8
B15_MESH, B15_STEP, B15_HALO = (2, 4), 60_000, 32
MESH_FLEET_INTERVALS = [(4, 60_000)] * 2 + [(120, 1_800_000)]
# the quantile probabilities every B8 check runs
PHIS = (-0.5, 0.0, 0.25, 0.5, 0.9, 1.0, 1.5)
# funcs whose kernel and plain version do the same operations with no sum
# and no division: held bit for bit (NaN positions included).  The
# time-valued funcs and lag divide by 1e3, which torch does for a CUDA
# tensor through the reciprocal, an ulp away from the kernel's division.
EXACT_FUNCS = frozenset({
    "count_over_time", "present_over_time", "first_over_time",
    "last_over_time", "default_rollup", "min_over_time", "max_over_time",
    "changes"})


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


def assert_exact(what: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Same NaN positions and the same bits everywhere else."""
    if got.shape != want.shape or not torch.equal(torch.isnan(got),
                                                  torch.isnan(want)):
        raise AssertionError(f"{what}: NaN positions differ")
    live = ~torch.isnan(got)
    if not torch.equal(got[live].view(torch.int64),
                       want[live].view(torch.int64)):
        raise AssertionError(f"{what}: not bit-identical")
    return 0.0


def assert_same_values(what: str, got: torch.Tensor,
                       want: torch.Tensor) -> float:
    """The same numbers at the same places: NaN positions equal and every
    other value equal as a number (-0.0 == 0.0: the plain aggregates'
    scatter does not order signed zeros)."""
    if got.shape != want.shape or not torch.equal(torch.isnan(got),
                                                  torch.isnan(want)):
        raise AssertionError(f"{what}: NaN positions differ")
    live = ~torch.isnan(got)
    if not torch.equal(got[live], want[live]):
        raise AssertionError(f"{what}: values differ")
    return 0.0


def _loose(func: str) -> tuple[float, float]:
    """(rtol, atol) of a func whose moment formula cancels: deriv and
    stdvar_over_time 1e-9; stddev_over_time the reference oracle's own
    bound, rtol 1e-6, atol 1e-4 (tests/test_device_rollup.py:69-74): a
    zero-variance window's stddev is the square root of a summation-order
    residual."""
    return (1e-6, 1e-4) if func == "stddev_over_time" else (1e-9, 1e-9)


def func_close(what, func, got, want) -> float:
    """Kernel vs plain per-series rollup: bit for bit for EXACT_FUNCS,
    rtol 1e-12 where only the summation order can differ, _loose for the
    cancelling moment formulas (see tests/test_torch_rollup_tile.py)."""
    if func in EXACT_FUNCS:
        return assert_exact(what, got, want)
    if func in ("deriv", "stddev_over_time", "stdvar_over_time"):
        return assert_close(what, got, want, *_loose(func))
    return assert_close(what, got, want, 1e-12, 0.0)


def aggr_close(what, aggr, got, want, func="rate", mean=None) -> float:
    """The tolerance of the port's tests: rtol 1e-12 for the sums and
    extrema; the variance to rtol 1e-9, atol 1e-9, stddev through its
    square, plus, for the funcs other than the counter funcs, 16 ulp of
    the squared group mean (its cancellation); the cancelling funcs at
    _loose (see tests/test_torch_device_rollup.py)."""
    loose = func in ("deriv", "stddev_over_time", "stdvar_over_time")
    rtol, atol = _loose(func) if loose else (1e-9, 1e-9)
    if aggr in ("stddev", "stdvar"):
        g, w = (got * got, want * want) if aggr == "stddev" else (got, want)
        g, w = g.double().cpu(), w.double().cpu()
        scale = atol
        if mean is not None and func not in dr.COUNTER_FUNCS:
            scale = atol + 16 * torch.finfo(torch.float64).eps * (
                1 + torch.nan_to_num(mean.double().cpu()) ** 2)
        if not torch.equal(torch.isnan(g), torch.isnan(w)):
            raise AssertionError(f"{what}: NaN positions differ")
        bad = ((g - w).abs() > scale + rtol * w.abs()) & ~torch.isnan(w)
        if bool(bad.any()):
            raise AssertionError(f"{what}: {g[bad][:5]} vs {w[bad][:5]}")
        return max_abs_err(got, want)
    if loose:
        return assert_close(what, got, want, rtol, atol)
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

def check_ranks(what: str, rolled) -> None:
    """B7 against its plain version: median and last bit for bit, avg at
    rtol 1e-12 (the plain cumsum's order differs), max and min equal as
    numbers (which zero torch.amax returns among -0.0 and 0.0 is not
    specified)."""
    for kind in dr.RANK_KINDS:
        g, w = dr.rank_rows(rolled, kind), dr.rank_rows_plain(rolled, kind)
        if kind in ("median", "last"):
            assert_exact(f"B7 {what} {kind}", g, w)
        else:
            assert_close(f"B7 {what} {kind}", g, w,
                         1e-12 if kind == "avg" else 0.0, 0.0)


def rank_edge_rows(T: int, rng, dev) -> torch.Tensor:
    """Rows of T steps holding B7's edge cases at shuffled steps (NaN
    elsewhere): no live step, one, two; ties straddling the median; -0.0
    and +0.0 at j0 and j1; infinities; constant rows; a run of ties with
    one outlier; and random rows (tests/test_torch_rank_rows.py holds the
    plain version against the reference on the same cases)."""
    h = T // 2
    cases = [
        [], [1.5], [2.0, -3.0],
        [1.0] * h + [2.0] * (T - h), [1.0] * (h + 1) + [2.0] * (T - h - 1),
        [-0.0, 0.0], [0.0, -0.0, 0.0], [-0.0] * h + [0.0] * (T - h),
        [np.inf, -np.inf] * h, [np.inf] * T, [-np.inf] * 3 + [np.inf] * 2,
        [7.25] * T, [7.25] * (T - 1), [-0.0] * T,
        [0.0] * (T - 1) + [1e300], [-1e300] + [5.0] * (T - 1),
        list(rng.normal(0, 1, T)), list(rng.integers(0, 3, T) * 1.0)]
    out = np.full((len(cases), T), np.nan)
    for r, vals in enumerate(cases):
        vals = np.asarray(vals[:T], dtype=np.float64)
        out[r, rng.permutation(T)[:vals.size]] = vals
    return torch.from_numpy(out).to(dev)


def topk_ks(S: int) -> list[int]:
    """B6's k at every path boundary: the old register path's 16 | 17,
    the scan path's K_REG | K_REG + 1 (the sort path), and S."""
    return sorted({k for k in (1, 10, 16, 17, dr.K_REG, dr.K_REG + 1, S)
                   if k <= S})


def check_topk(what: str, rolled, ks=None) -> None:
    """B6 against its plain version, picks and NaN flags bit for bit, at
    each k of ks (every k of topk_ks by default), top and bottom."""
    for bottom in (False, True):
        for k in ks or topk_ks(rolled.shape[0]):
            gi, gn = dr.topk_select(rolled, k, bottom)
            wi, wn = dr.topk_select_plain(rolled, k, bottom)
            assert_equal(f"B6 {what} k={k} bottom={bottom} idx", gi, wi)
            assert_equal(f"B6 {what} k={k} bottom={bottom} nan", gn, wn)


def check_selections(what: str, rolled, dev) -> None:
    """B6, take_rows, B7 and B8 on one rolled tile against their plain
    versions: B6 at every k of topk_ks top and bottom, take_rows with
    int32 and int64 indices (out-of-range ones among them), every rank
    kind, every phi at groups of 32 and at one group of all rows."""
    S, T = rolled.shape
    check_topk(what, rolled)
    sel = torch.tensor([S - 1, -1, 0, S, S // 2, -S - 3, 2 * S], device=dev)
    for dtype in (torch.int64, torch.int32):
        assert_equal(f"take_rows {what} {dtype}",
                     dr.take_rows(rolled, sel.to(dtype)),
                     dr.take_rows_plain(rolled, sel.to(dtype)))
    check_ranks(what, rolled)
    for n_groups in (max(S // 32, 1), 1):
        gids = (torch.arange(S, device=dev) % n_groups).to(torch.int32)
        groups = dr.group_layout(gids, n_groups, dev)
        for phi in PHIS:
            assert_exact(f"B8 {what} M={groups.max_group} phi={phi}",
                         dr.quantile_groups(rolled, groups, phi),
                         dr.quantile_groups_plain(rolled, groups, phi))


def check_quantile(what: str, rolled, groups, want_plan) -> dict:
    """B8 bit for bit against its plain version at every phi, on the path
    `want_plan` names ((path, cluster, staged), None for any)."""
    S, T = rolled.shape
    plan = dr.quantile_plan(groups.num_groups, T, groups.max_group,
                            kernels.sm_count(rolled.device))
    if want_plan is not None and \
            (plan.path, plan.cluster, plan.staged) != want_plan:
        raise AssertionError(f"B8 {what}: plan {plan}, not {want_plan}")
    for phi in PHIS:
        assert_exact(f"B8 {what} phi={phi}",
                     dr.quantile_groups(rolled, groups, phi),
                     dr.quantile_groups_plain(rolled, groups, phi))
    return plan._asdict()


def check_quantile_paths(rng, dev) -> dict:
    """B8's cluster and block paths at their edges, on values with ties,
    signed zeros, infinities and NaN: one group of 100,000 rows at one
    step (16 staged members), groups at and just above what a cluster
    stages (16 x 24,576 keys), a group that 16 does not divide, a group
    just above what one block stages (the block path, 132 steps), and
    three groups of which one is all NaN and one has a single live row."""
    pool = torch.tensor([-0.0, 0.0, 1.0, -1.0, torch.inf, -torch.inf,
                         torch.nan, 2.5], dtype=torch.float64, device=dev)

    def values(S, T):
        v = torch.from_numpy(np.round(rng.normal(0, 3, (S, T)), 1)).to(dev)
        pick = torch.from_numpy(rng.random((S, T)) < 0.3).to(dev)
        return torch.where(pick, pool[torch.from_numpy(
            rng.integers(0, 8, (S, T))).to(dev)], v)

    def one(S):
        return dr.group_layout(torch.zeros(S, dtype=torch.int32, device=dev),
                               1, dev)

    cl = dr.Q_CLUSTER
    plans = {}
    for what, S, T, want in (("one group 100000", 100_000, 1, (cl, 16, 1)),
                             ("cluster stage limit", 393_216, 1, (cl, 16, 1)),
                             ("above cluster stage", 393_217, 1, (cl, 16, 0)),
                             ("16 does not divide", 100_003, 2, (cl, 16, 1)),
                             ("above block stage", 24_577, 132,
                              (dr.Q_BLOCK, 1, 0))):
        plans[what] = check_quantile(what, values(S, T), one(S), want)
    r = values(60_000, 2)
    r[:40_000] = torch.nan         # group 0: all NaN
    r[40_000:50_000] = torch.nan   # group 1: one live row
    r[40_017] = 3.5
    gids = torch.repeat_interleave(
        torch.arange(3, device=dev, dtype=torch.int32),
        torch.tensor([40_000, 10_000, 10_000], device=dev))
    plans["nan and one live"] = check_quantile(
        "all NaN, one live", r, dr.group_layout(gids, 3, dev), (cl, 16, 1))
    return plans


def kernels_slice2(rng, dev, ts_t, v_t, counts, ragged) -> dict:
    """B5-B8 against their plain versions on the card (ragged rows, the
    dashboard tile, tie-heavy and wide tiles), timed at the dashboard
    shape."""
    res = {}
    S = DASH_SERIES
    start, end = dashboard_grid()
    cfg = dr.normalized_cfg("rate", RollupConfig(start, end, DASH_STEP,
                                                 WINDOW))
    T = dr.num_steps(cfg)
    n_valid = int(counts.sum())
    none = int(dr.MIN_TS_NONE)
    roll = (SCRAPE, -(WINDOW + LOOKBACK_DELTA))  # a refresh's (shift, min_ts)
    # B5: every func, on the ragged rows and the dashboard tile, with and
    # without a shift and a fetch bound
    rcfg0 = RollupConfig(T_START + 600_000, T_START + 1_800_000, 60_000,
                         WINDOW)
    err5 = 0.0
    cases = []
    for off, mt in ((0, none), (120_000, -420_000)):
        tsr, vr, cr = (torch.from_numpy(a).to(dev) for a in dr.pack_series(
            ragged, rcfg0.start - off))
        cases.append(("ragged", tsr, vr, cr, rcfg0, off, mt))
    dcfg0 = RollupConfig(start, end, DASH_STEP, WINDOW)
    cases += [("dashboard", ts_t, v_t, counts, dcfg0, 0, none),
              ("dashboard", ts_t, v_t, counts, dcfg0, *roll)]
    for what, tsx, vx, cx, cfg0, off, mt in cases:
        for func in dr.FUNC_CODES:
            if off and func in dr.TIME_VALUED_FUNCS:
                continue  # they refuse a shifted grid
            c = dr.normalized_cfg(func, cfg0)
            g = dr.rollup_tile(func, tsx, vx, cx, c, mt, off)
            # the plan's path (staged on these shapes) against the global
            # search, bit for bit
            assert_equal(f"B5 {func} {what} shift {off} plan vs global", g,
                         dr.rollup_tile(func, tsx, vx, cx, c, mt, off,
                                        force_global=True))
            w = dr.rollup_tile_plain(func, tsx - off, vx, cx, c, mt)
            e = func_close(f"B5 {func} {what} shift {off}", func, g, w)
            if func not in dr.TIME_VALUED_FUNCS and \
                    func not in ("deriv", "stddev_over_time",
                                 "stdvar_over_time"):
                err5 = max(err5, e)
    b5 = lambda: dr.rollup_tile("rate", ts_t, v_t, counts, cfg)  # noqa: E731
    rolled = b5()
    if not bool(torch.isfinite(rolled[:, WINDOW // DASH_STEP + 1:]).all()):
        raise AssertionError("B5 dashboard: non-finite rates")
    plan5 = dr.b5_plan(S, int(ts_t.shape[1]), T, cfg.step, cfg.lookback,
                       dr.scrape_hint(int(ts_t.shape[1]), T, cfg.step,
                                      cfg.lookback), kernels.sm_count(dev))
    if plan5.path != dr.K2_STAGED:
        raise AssertionError(f"B5 dashboard: plan {plan5} is not staged")
    res["rollup_tile"] = dict(
        max_abs_err=err5, ms=cuda_ms(b5), device_ms=device_ms(b5),
        global_device_ms=device_ms(lambda: dr.rollup_tile(
            "rate", ts_t, v_t, counts, cfg, force_global=True)),
        plan=plan5._asdict(),
        plain_ms=cuda_ms(lambda: dr.rollup_tile_plain(
            "rate", ts_t, v_t, counts, cfg), reps=3),
        ms_by_func={f: cuda_ms(lambda f=f: dr.rollup_tile(
            f, ts_t, v_t, counts, dr.normalized_cfg(f, dcfg0)), reps=3)
            for f in ("sum_over_time", "stddev_over_time", "deriv",
                      "changes", "default_rollup")},
        **bound(n_valid * 12 + S * 4 + S * T * 8, 15 * S * T))

    # B6, take_rows, B7, B8 on the dashboard rates, the ragged rows'
    # rates, a tile of ties (signed zeros, infinities, NaN rows) and, for
    # B6 and B7, tiles taller or wider than the kernels' shared-memory
    # staging
    pool = torch.tensor([-0.0, 0.0, 1.0, -1.0, torch.inf, -torch.inf,
                         torch.nan], dtype=torch.float64, device=dev)
    ties = pool[torch.from_numpy(rng.integers(0, 7, (S, T))).to(dev)]
    ties[::97] = torch.nan
    wide = torch.from_numpy(rng.normal(0, 1, (64, 30_000))).to(dev)
    wide[wide > 2.0] = torch.nan
    wide[3] = torch.nan
    tsr, vr, cr = cases[0][1:4]
    rag_rolled = dr.rollup_tile("rate", tsr, vr, cr,
                                dr.normalized_cfg("rate", rcfg0))
    for what, r in (("dashboard", rolled), ("ragged", rag_rolled),
                    ("ties", ties)):
        check_selections(what, r, dev)
    # B6 on a tile taller than the sort path stages in shared memory
    tall = pool[torch.from_numpy(rng.integers(0, 7, (30_000, 4))).to(dev)]
    tall[1::3] = torch.from_numpy(rng.normal(0, 1, (10_000, 4))).to(dev)
    check_topk("tall", tall)
    # row counts that no cluster of the plan divides: the last member's
    # range is shorter than the others'
    for what, r, rows in (("dashboard", rolled, 8191), ("ties", ties, 5001)):
        plan = dr.topk_plan(rows, T, 10, kernels.sm_count(dev))
        if plan.cluster < 2 or rows % plan.cluster == 0:
            raise AssertionError(f"B6 {rows} rows: plan {plan} splits evenly")
        check_topk(f"{what} rows :{rows}", r[:rows], (10, dr.K_REG))
    check_ranks("wide", wide)
    # B7's edge rows on each median path and its boundaries: the warp path
    # (T <= 1024, below, at and above a warp's 32), a block per row (the
    # full width's 5761, the most a block stages) and global memory
    for T_e in (1, 2, 31, 32, 33, 355, 1024, 1025, 5761, 24576, 24577):
        check_ranks(f"edge rows T={T_e}", rank_edge_rows(T_e, rng, dev))
    quantile_plans = check_quantile_paths(rng, dev)

    # times: cuda_ms as in earlier runs, device_ms (back-to-back calls)
    # and host_ms (the wrapper's host time), for the kernels and their
    # library calls
    key = dr._topk_key(rolled, False).T.contiguous()
    k10 = three_ms(lambda: dr.topk_select(rolled, 10, False))
    lib10 = three_ms(lambda: torch.topk(key, 10, dim=1))
    res["topk_select_tile"] = dict(
        max_abs_err=0.0,  # picks identical, checked above
        **k10, plain_ms=cuda_ms(lambda: dr.topk_select_plain(
            rolled, 10, False), reps=3),
        library_ms=lib10["ms"], library=lib10,
        k20=three_ms(lambda: dr.topk_select(rolled, 20, False)),
        library_k20=three_ms(lambda: torch.topk(key, 20, dim=1)),
        k_all=three_ms(lambda: dr.topk_select(rolled, S, False), n=10,
                       reps=3),
        plan_k10=dr.topk_plan(S, T, 10, kernels.sm_count(dev))._asdict(),
        **topk_bound(S, T, 10))
    idx, _ = dr.topk_select(rolled, 10, False)
    sel = torch.unique(idx.long())
    M = int(sel.numel())
    t64 = three_ms(lambda: dr.take_rows(rolled, sel))
    lib = three_ms(lambda: torch.index_select(rolled, 0, sel))
    sel32 = sel.to(torch.int32)
    res["take_rows"] = dict(
        max_abs_err=0.0, rows=M, **t64,
        int32=three_ms(lambda: dr.take_rows(rolled, sel32)),
        plain_ms=cuda_ms(lambda: dr.take_rows_plain(rolled, sel)),
        library_ms=lib["ms"], library=lib,
        **take_rows_bound(M, T))
    res["rank_tile"] = dict(
        max_abs_err=float(max_abs_err(dr.rank_rows(rolled, "avg"),
                                      dr.rank_rows_plain(rolled, "avg"))),
        ms=cuda_ms(lambda: dr.rank_rows(rolled, "median")),
        plain_ms=cuda_ms(lambda: dr.rank_rows_plain(rolled, "median")),
        library_ms=cuda_ms(lambda: torch.nanquantile(rolled, 0.5, dim=1)),
        ms_by_kind={k: cuda_ms(lambda k=k: dr.rank_rows(rolled, k))
                    for k in dr.RANK_KINDS},
        device_ms_by_kind={k: device_ms(lambda k=k: dr.rank_rows(rolled, k))
                           for k in dr.RANK_KINDS},
        # avg's one PyTorch call (NaN on an all-NaN row, as B7)
        library_avg_ms=cuda_ms(lambda: torch.nanmean(rolled, dim=1)),
        library_avg_device_ms=device_ms(
            lambda: torch.nanmean(rolled, dim=1)),
        plan=dr.rank_plan(S, T, kernels.sm_count(dev))._asdict(),
        ms_wide_median=cuda_ms(lambda: dr.rank_rows(wide, "median"), reps=3),
        **bound(S * T * 8 + S * 8, S * T))
    gids = (torch.arange(S, device=dev) % DASH_GROUPS).to(torch.int32)
    g32 = dr.group_layout(gids, DASH_GROUPS, dev)
    g_all = dr.group_layout(torch.zeros(S, dtype=torch.int32, device=dev), 1,
                            dev)
    dense = dr.dense_by_group(rolled, g32)
    dense_all = dr.dense_by_group(rolled, g_all)
    sms = kernels.sm_count(dev)
    res["rollup_quantile_tile"] = dict(
        max_abs_err=0.0,  # identical, checked above
        ms=cuda_ms(lambda: dr.quantile_groups(rolled, g32, 0.9)),
        plain_ms=cuda_ms(lambda: dr.quantile_groups_plain(rolled, g32, 0.9)),
        library_ms=cuda_ms(lambda: torch.nanquantile(dense, 0.9, dim=1)),
        ms_one_group=cuda_ms(lambda: dr.quantile_groups(rolled, g_all, 0.5)),
        library_ms_one_group=cuda_ms(lambda: torch.nanquantile(
            dense_all, 0.5, dim=1), reps=3),
        # ms, device_ms and host_ms of B8 and torch.nanquantile (on the
        # reference's dense [G, M, T]) at M = 32 and M = 8192
        m32=three_ms(lambda: dr.quantile_groups(rolled, g32, 0.9)),
        library_m32=three_ms(lambda: torch.nanquantile(dense, 0.9, dim=1)),
        m8192=three_ms(lambda: dr.quantile_groups(rolled, g_all, 0.5)),
        library_m8192=three_ms(lambda: torch.nanquantile(
            dense_all, 0.5, dim=1), n=10, reps=3),
        bound_ms_m8192=quantile_bound(S, T, 1)["bound_ms"],
        plan_m32=dr.quantile_plan(DASH_GROUPS, T, 32, sms)._asdict(),
        plan_m8192=dr.quantile_plan(1, T, S, sms)._asdict(),
        paths=quantile_plans, **quantile_bound(S, T, DASH_GROUPS))
    return res


def kernels_fleet(rng, dev, ts_t, v_t, counts) -> dict:
    """B9, B10 and B11 against their plain versions at a fleet bucket's
    shape: FLEET_B slots of FLEET_N columns holding the dashboard tile,
    FLEET_LIVE of them live streams, each with its own grid shift, fetch
    bound and aggregate (all eight mixed), its last 64 rows padded; the
    rest padded slots.  Slot 1 has a counter reset on every 64th row,
    slot 2 -0.0 at the row starts, slot 3 NaN and stale NaN samples,
    slots 4 and 5 gaps before the grid; the last group is empty in every
    stream.  B9 runs the fleet phase's funcs
    at the aggregate tolerances, B10 and B11 bit for bit.  Returns the
    largest difference per kernel."""
    S, N0 = ts_t.shape
    B, LIVE, N, G = FLEET_B, FLEET_LIVE, FLEET_N, DASH_GROUPS
    ts = torch.full((B, S, N), int(dr.TS_PAD), dtype=torch.int32, device=dev)
    vals = torch.zeros((B, S, N), dtype=torch.float64, device=dev)
    cnt = torch.zeros((B, S), dtype=torch.int32, device=dev)
    ts[:LIVE, :, :N0] = ts_t
    vals[:LIVE, :, :N0] = v_t
    cnt[:LIVE] = counts
    ts[:LIVE, -64:], vals[:LIVE, -64:], cnt[:LIVE, -64:] = int(dr.TS_PAD), \
        0.0, 0
    rows = torch.arange(0, S - 64, 64, device=dev)
    mid = (counts[rows].long() // 2)[:, None]
    cols = torch.arange(N, device=dev)[None, :]
    v1 = vals[1, rows]
    vals[1, rows] = torch.where(cols >= mid, v1 - v1.gather(1, mid), v1)
    vals[2, ::97, :3] = -0.0
    vals[3, 5::101, 10] = torch.nan
    vals[3, 7::101, 20] = dec.STALE_NAN
    # gaps: every 50th row of slots 4 and 5 has its first 40 samples 10
    # minutes earlier, so the sample before a window can lie below the
    # fetch bound, which gates it in slot 5 (min_ts) and not in slot 4
    gap = torch.arange(0, S - 64, 50, device=dev)
    ts[4:6, gap, :40] -= 600_000
    gids = torch.from_numpy(rng.integers(0, G - 1, (B, S))).to(
        device=dev, dtype=torch.int32)
    layout = dr.fleet_layout(gids, G, dev)
    aggr = torch.tensor([b % 8 if b < LIVE else 0 for b in range(B)],
                        dtype=torch.int32, device=dev)
    shift = torch.tensor([b * SCRAPE for b in range(B)], dtype=torch.int32,
                         device=dev)
    min_ts = torch.tensor(
        [-(WINDOW + LOOKBACK_DELTA) if b % 2 else int(dr.MIN_TS_NONE)
         for b in range(B)], dtype=torch.int32, device=dev)
    v0 = torch.zeros((B, S), dtype=torch.float64, device=dev)
    cfg0 = RollupConfig(0, (FLEET_T - 1) * DASH_STEP, DASH_STEP, WINDOW)
    names = {code: name for name, code in dr.FLEET_AGGR_CODES.items()}
    err = dict.fromkeys(FLEET_KERNELS, 0.0)
    for func in FLEET_FUNCS:
        cfg = dr.normalized_cfg(func, cfg0)
        args = (func, cfg, layout, ts, vals, cnt, aggr, shift, min_ts, v0)
        got = dr.fleet_rollup_aggregate_tile(*args)
        want = dr.fleet_rollup_aggregate_tile_plain(*args)
        mean = None
        if func not in dr.COUNTER_FUNCS:  # the variance's 16-ulp term
            mean = dr.fleet_rollup_aggregate_tile_plain(
                func, cfg, layout, ts, vals, cnt, torch.full_like(aggr, 2),
                shift, min_ts, v0)
        for b in range(LIVE):
            name = names[int(aggr[b])]
            e = aggr_close(f"B9 {func} slot {b} {name}", name, got[b],
                           want[b], func, None if mean is None else mean[b])
            if name not in ("stddev", "stdvar"):
                err["fleet_rollup_aggregate_tile"] = max(
                    err["fleet_rollup_aggregate_tile"], e)
        if not (bool(torch.isnan(got[LIVE:]).all()) and
                bool(torch.isnan(got[:, G - 1]).all())):
            raise AssertionError(f"B9 {func}: a padded slot or the empty "
                                 "group is not NaN")
        if not bool(torch.isfinite(got[:LIVE, :G - 1]).any()):
            raise AssertionError(f"B9 {func}: no finite value")
    # B9 over groups larger than its chunk (FLEET_CHUNK), which it walks in
    # chunks and folds: in slots 0, 3, ... every row is one group; in 1,
    # 4, ... three interleaved groups of ~2731 rows (the last chunk
    # shorter); in 2, 5, ... a group of the first 300 rows, one of every
    # 40th row after them (~197: one pass) and one of the rest
    r = torch.arange(S, device=dev)
    gids1 = torch.zeros((B, S), dtype=torch.int32, device=dev)
    gids1[1::3] = (r % 3).to(torch.int32)
    gids1[2::3] = torch.where(r < 300, 0, torch.where(r % 40 == 0, 1, 2)).to(
        torch.int32)
    layout1 = dr.fleet_layout(gids1, 3, dev)
    if dr.fleet_chunks(layout1) < 2:
        raise AssertionError("B9 large groups: not chunked")
    per_stream = [dr.group_layout(gids1[b], 3, dev) for b in range(LIVE)]
    bitwise = {}  # B9 == K2 per stream, bit for bit, in each other aggregate
    for func in FLEET_FUNCS:
        cfg = dr.normalized_cfg(func, cfg0)
        args = (func, cfg, layout1, ts, vals, cnt, aggr, shift, min_ts, v0)
        got = dr.fleet_rollup_aggregate_tile(*args)
        want = dr.fleet_rollup_aggregate_tile_plain(*args)
        mean = dr.fleet_rollup_aggregate_tile_plain(
            func, cfg, layout1, ts, vals, cnt, torch.full_like(aggr, 2),
            shift, min_ts, v0) if func not in dr.COUNTER_FUNCS else None
        for b in range(LIVE):
            name = names[int(aggr[b])]
            e = aggr_close(f"B9 large groups {func} slot {b} {name}", name,
                           got[b], want[b], func,
                           None if mean is None else mean[b])
            if name not in ("stddev", "stdvar"):
                err["fleet_rollup_aggregate_tile"] = max(
                    err["fleet_rollup_aggregate_tile"], e)
        if not bool(torch.isfinite(got[:LIVE]).any()):
            raise AssertionError(f"B9 large groups {func}: no finite value")
        # K2 on each stream's tile, chunked by the same rule: count,
        # group, min and max bit for bit; whether the others come out bit
        # for bit too is recorded
        for name in dr.AGGR_FUNCS:
            code = torch.full_like(aggr, dr.FLEET_AGGR_CODES[name])
            got = dr.fleet_rollup_aggregate_tile(func, cfg, layout1, ts, vals,
                                                 cnt, code, shift, min_ts, v0)
            for b in range(LIVE):
                k2 = dr.rollup_aggregate_tile(func, name, ts[b], vals[b],
                                              cnt[b], per_stream[b], cfg,
                                              int(shift[b]), int(min_ts[b]))
                what = f"B9 large groups {func} slot {b} {name} vs K2"
                if name in ("count", "group", "min", "max"):
                    assert_equal(what, got[b], k2)
                else:
                    same = bool(torch.equal(got[b].view(torch.int64),
                                            k2.view(torch.int64)))
                    bitwise[name] = bitwise.get(name, True) and same
    # B10: a steady interval's columns, on rows near the capacity too
    K = 8
    new_ts = (ts.gather(2, (cnt.long() - 1).clamp(min=0)[..., None]) +
              SCRAPE * (1 + torch.arange(K, device=dev))).to(torch.int32)
    new_vals = torch.from_numpy(rng.normal(0, 1e3, (B, S, K))).to(dev)
    new_counts = torch.from_numpy(rng.integers(0, K + 1, (B, S))).to(
        device=dev, dtype=torch.int32)
    new_counts[0] = 0  # nothing staged for slot 0
    near = cnt.clone()
    near[4, ::3] = N - 3  # rows whose tail runs past the capacity
    got = dr.fleet_append_tile(ts.clone(), vals.clone(), near.clone(),
                               new_ts, new_vals, new_counts)
    want = dr.fleet_append_tile_plain(ts.clone(), vals.clone(), near.clone(),
                                      new_ts, new_vals, new_counts)
    for g, w, what in zip(got, want, ("ts", "values", "counts")):
        assert_equal(f"B10 {what}", g, w)
    # at K 16 and 24 (8 and 16 lanes a row: a refresh after a gap, a fleet
    # interval of 9 or more scrapes), from a generator of their own so the
    # checks after them see the same data
    krng = np.random.default_rng(1024)
    for K in (16, 24):
        new_ts = (ts.gather(2, (cnt.long() - 1).clamp(min=0)[..., None]) +
                  SCRAPE * (1 + torch.arange(K, device=dev))).to(torch.int32)
        new_vals = torch.from_numpy(krng.normal(0, 1e3, (B, S, K))).to(dev)
        new_counts = torch.from_numpy(krng.integers(0, K + 1, (B, S))).to(
            device=dev, dtype=torch.int32)
        new_counts[0] = 0
        new_counts[1] = K
        tail = cnt.clone()
        tail[4, 1::3] = N - K // 2
        got = dr.fleet_append_tile(ts.clone(), vals.clone(), tail.clone(),
                                   new_ts, new_vals, new_counts)
        want = dr.fleet_append_tile_plain(ts.clone(), vals.clone(),
                                          tail.clone(), new_ts, new_vals,
                                          new_counts)
        for g, w, what in zip(got, want, ("ts", "values", "counts")):
            assert_equal(f"B10 K={K} {what}", g, w)
    # and at the 30-minute resume's K (a warp a row)
    K = 120
    new_ts = (ts.gather(2, (cnt.long() - 1).clamp(min=0)[..., None]) +
              SCRAPE * (1 + torch.arange(K, device=dev))).to(torch.int32)
    new_vals = torch.from_numpy(rng.normal(0, 1e3, (B, S, K))).to(dev)
    new_counts = torch.from_numpy(rng.integers(0, K + 1, (B, S))).to(
        device=dev, dtype=torch.int32)
    new_counts[0] = 0
    new_counts[1] = K
    near[4, 1::3] = N - 60
    got = dr.fleet_append_tile(ts.clone(), vals.clone(), near.clone(),
                               new_ts, new_vals, new_counts)
    want = dr.fleet_append_tile_plain(ts.clone(), vals.clone(), near.clone(),
                                      new_ts, new_vals, new_counts)
    for g, w, what in zip(got, want, ("ts", "values", "counts")):
        assert_equal(f"B10 K={K} {what}", g, w)
    del got, want
    # B11: per-slot cutoffs; slots 2 and 5 are not compacted (cutoff 0),
    # yet every slot's live samples below 0 (the lookback prefix of the
    # cold tile's base) drop, as in the reference
    cut = torch.tensor([0 if b in (2, 5) else 420 * SCRAPE + b * 45_000
                        for b in range(B)], dtype=torch.int32, device=dev)
    got = dr.fleet_compact_tile(ts, vals, cnt, cut, cut)
    want = dr.fleet_compact_tile_plain(ts, vals, cnt, cut, cut)
    for g, w, what in zip(got, want, ("ts", "values", "counts")):
        assert_equal(f"B11 {what}", g, w)
    if not bool((got[2][2] < cnt[2]).any()):
        raise AssertionError("B11: a cutoff-0 slot kept its ts < 0")
    return err, bitwise, (cfg0, layout, ts, vals, cnt, aggr, shift, min_ts,
                          v0, gids, gids1)


def mesh_close(what, aggr, got, want, func="rate", mean=None) -> float:
    """A sharded aggregate against the unsharded one: count, group, min
    and max bit for bit (B13 folds its shards in row order), the others at
    aggr_close's tolerances (only the sums' association differs)."""
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    if aggr in ("count", "group", "min", "max"):
        return assert_exact(what, got, want)
    return aggr_close(what, aggr, got, want, func, mean)


def sequential_moments(aggr: str, rolled: torch.Tensor,
                       layout) -> torch.Tensor:
    """The moments [M, G, T] of a walk of each group's rows in ascending
    order, one add after another (the per-shard pass's order for a group
    of at most FLEET_CHUNK members)."""
    G, T = layout.num_groups, rolled.shape[1]
    order, starts = layout.order.long(), layout.starts.long()
    sizes = starts[1:] - starts[:-1]
    m = {"cnt": torch.zeros((G, T), dtype=torch.float64, device=rolled.device)}
    m["s1"], m["s2"] = torch.zeros_like(m["cnt"]), torch.zeros_like(m["cnt"])
    m["min"] = torch.full_like(m["cnt"], torch.inf)
    m["max"] = torch.full_like(m["cnt"], -torch.inf)
    for k in range(layout.max_group):
        v = rolled[order[(starts[:-1] + k).clamp(max=len(order) - 1)]]
        live = (k < sizes)[:, None] & ~torch.isnan(v)
        m["cnt"] = torch.where(live, m["cnt"] + 1.0, m["cnt"])
        m["s1"] = torch.where(live, m["s1"] + v, m["s1"])
        m["s2"] = torch.where(live, m["s2"] + v * v, m["s2"])
        m["min"] = torch.where(live & (v < m["min"]), v, m["min"])
        m["max"] = torch.where(live & (v > m["max"]), v, m["max"])
    return torch.stack([m[k] for k in dr.MOMENTS[aggr]])


def sharded_plain(mesh, func, aggr, shards, layouts, cfg, shift=0,
                  min_ts=dr.MIN_TS_NONE):
    """B13's plain version: each shard's plain moments, then the plain
    combine in shard order."""
    mom = torch.stack([dr.rollup_group_moments_plain(
        func, aggr, t, v, c, g, cfg, shift, min_ts)
        for t, v, c, g in zip(*shards, layouts)])
    return meshlib.combine_group_moments_plain(aggr, mom)


class _CountingLib:
    """A loaded kernel library whose vm_* calls count into `calls`."""

    def __init__(self, lib, calls: collections.Counter):
        self._lib, self._calls = lib, calls

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if not name.startswith("vm_") or name == "vm_cuda_error_string":
            return fn

        def counted(*args):
            self._calls[name] += 1
            return fn(*args)
        return counted


def b15_phase_calls(step, parts) -> dict:
    """The C launchers one B15 call runs, with how often, and its host
    syncs (Tensor.item)."""
    calls = collections.Counter()
    libs = {n: kernels.lib(n) for n in ("mesh", "rollup")}
    item = torch.Tensor.item

    def counted_item(self):
        calls["syncs"] += 1
        return item(self)

    try:
        for n, h in libs.items():
            kernels._libs[n] = _CountingLib(h, calls)
        torch.Tensor.item = counted_item
        step(*parts)
    finally:
        kernels._libs.update(libs)
        torch.Tensor.item = item
    return dict(calls)


def check_b15_phases(what: str, func: str, step, parts, cards: int) -> dict:
    """One B15 call launches the halo pass, the row scan and the series
    pass once per card (the scratch pass at most once), and syncs with the
    host at most once (the counter funcs' irregular rows), whatever the
    shards a card holds."""
    got = b15_phase_calls(step, parts)
    want = {"vm_halo_compact": cards, "vm_time_shards_scan": cards,
            "vm_time_shards_series": cards}
    if {k: got.get(k, 0) for k in want} != want or \
            got.get("vm_time_shards_prep", 0) > cards or \
            got.get("syncs", 0) > (1 if func in dr.COUNTER_FUNCS else 0) or \
            set(got) - set(want) - {"vm_time_shards_prep", "syncs"}:
        raise AssertionError(f"{what}: launches {got}, want {want} on "
                             f"{cards} card(s)")
    return got


def check_halo_rows(what: str, mesh, parts, halo: int, cfg) -> dict:
    """B15's halo pass over the mesh's (one card's) shards against
    halo_compact_plain, row by row: a row read in place is its tile
    segment (halo then columns), every sample valid; a compacted row holds
    the plain compaction's valid prefix.  Both kinds must occur.  Returns
    the count of each."""
    ((dev, batch),) = meshlib.time_shard_batches(mesh)
    n_time = len(parts[0][0])
    T = dr.num_steps(cfg) // n_time
    out = torch.empty((sum(int(p[0].shape[0]) for p in parts[0]),
                       T * n_time), dtype=torch.float64, device=dev)
    shards = []
    for i, j in batch:
        H = min(halo, int(parts[0][i][j].shape[1])) if j else 0
        left = tuple(x[i][j - 1] for x in parts) if H else None
        shards.append(meshlib.TimeShard(*(x[i][j] for x in parts), left, H,
                                        0, out))
    hr = meshlib.halo_rows(shards)
    r0, n = 0, collections.Counter()
    for sh in shards:
        R, C = sh.ts.shape
        H = sh.halo
        hal = tuple(x[:, -H:] for x in sh.left) if H else (None,) * 3
        wt, wv, wc = meshlib.halo_compact_plain(*sh[:3], *hal, 0)
        rows = slice(r0, r0 + R)
        src = hr.src[rows].bool()
        assert_equal(f"B15 {what} counts", hr.counts[rows], wc)
        seg = [torch.cat([h, x], 1) if H else x for h, x in zip(hal, sh[:2])]
        live = torch.arange(H + C, device=dev)[None, :] < wc[:, None]
        for name, comp, s_, w in (("ts", hr.ts, seg[0], wt),
                                  ("values", hr.values, seg[1], wv)):
            g = torch.where(src[:, None], comp[rows, :H + C], s_)
            assert_equal(f"B15 {what} {name}", torch.where(live, g, 0),
                         torch.where(live, w, 0))
        # in place only where every sample is valid
        if not bool((wc[~src] == H + C).all()):
            raise AssertionError(f"B15 {what}: a row with a gap in place")
        n["in_place"] += int((~src).sum())
        n["compacted"] += int(src.sum())
        r0 += R
    if not n["in_place"] or not n["compacted"]:
        raise AssertionError(f"B15 {what}: one source only ({dict(n)})")
    return dict(n)


def kernels_mesh(dev, dash_planes, edge_planes, tile, ragged, bucket) -> dict:
    """B12-B15 against their plain versions and the unsharded kernels on
    the card, timed at the dashboard shape.  B12: every func on the edge
    planes (int8/16/32 d2), in shared memory and through the scratch
    path, bit for bit against K1 -> B5; B13: every func and aggregate on
    the ragged rows over 8 logical shards, unshifted and shifted, and the
    dashboard tile; B14: the fleet bucket of kernels_fleet over 4 stream
    shards, bit for bit against B9; B15: every func but lifetime on a
    (2, 4) mesh over the dashboard tile's columns, against B5 and its
    plain version."""
    res = {}
    S, G = DASH_SERIES, DASH_GROUPS
    ts_t, v_t, counts = tile
    start, end = dashboard_grid()
    dcfg0 = RollupConfig(start, end, DASH_STEP, WINDOW)
    cfg = dr.normalized_cfg("rate", dcfg0)
    T = dr.num_steps(cfg)
    n_valid = int(counts.sum())
    # B12
    err12 = 0.0
    rcfg0 = RollupConfig(T_START + 600_000, T_START + 9_000_000, 60_000,
                         WINDOW)
    for a, nc in edge_planes:
        k1 = dd.decode_tiles(*a, nc)
        for func in dr.FUNC_CODES:
            c = dr.normalized_cfg(func, rcfg0)
            want = dr.rollup_tile(func, *k1, a[7], c)
            for force in (False, True):
                got = dd.decode_and_rollup(func, *a, c, nc, force)
                assert_equal(f"B12 {func} {a[2].dtype} scratch {force}",
                             got, want)
            e = func_close(f"B12 {func} plain", func, got,
                           dd.decode_and_rollup_plain(func, *a, c, nc))
            if func in dr.COUNTER_FUNCS:
                err12 = max(err12, e)
    args, n_cap = dash_planes
    b12 = lambda: dd.decode_and_rollup(  # noqa: E731
        "rate", *args, cfg, n_cap)
    assert_equal("B12 dashboard", b12(),
                 dr.rollup_tile("rate", ts_t, v_t, counts, cfg))
    plane_bytes = sum(t.numel() * t.element_size() for t in args)
    res["decode_and_rollup"] = dict(
        max_abs_err=err12, ms=cuda_ms(b12),
        plain_ms=cuda_ms(lambda: dd.decode_and_rollup_plain(
            "rate", *args, cfg, n_cap), reps=3),
        library_ms=None,
        ms_scratch=cuda_ms(lambda: dd.decode_and_rollup(
            "rate", *args, cfg, n_cap, True)),
        ms_k1_then_b5=cuda_ms(lambda: dr.rollup_tile(
            "rate", *dd.decode_tiles(*args, n_cap), counts, cfg)),
        **bound(plane_bytes + S * T * 8, 2 * 2 * S * n_cap + 15 * S * T))

    # B13 over 8 logical shards
    mesh = meshlib.make_mesh(MESH_SHARDS, 1, [dev] * MESH_SHARDS)
    err13 = 0.0
    rg = len(ragged)
    pad = -(-rg // MESH_SHARDS) * MESH_SHARDS
    rgids = np.zeros(pad, np.int32)
    rgids[:rg] = np.arange(rg) * 7 % 4
    for off, mt in ((0, int(dr.MIN_TS_NONE)), (120_000, -420_000)):
        tsr, vr, cr = dr.pack_series(ragged, rcfg0.start - 600_000 - off)
        tsr = np.concatenate([tsr, np.full((pad - rg, tsr.shape[1]),
                                           dr.TS_PAD, np.int32)])
        vr = np.concatenate([vr, np.zeros((pad - rg, vr.shape[1]))])
        cr = np.concatenate([cr, np.zeros(pad - rg, np.int32)])
        whole = [torch.from_numpy(x).to(dev) for x in (tsr, vr, cr)]
        shards = [split_rows(mesh, "series", x) for x in whole]
        layouts = [dr.group_layout(g, 5, dev) for g in split_rows(
            mesh, "series", torch.from_numpy(rgids).to(dev))]
        flat = dr.group_layout(rgids, 5, dev)
        for func in dr.FUNC_CODES:
            if off and func in dr.TIME_VALUED_FUNCS:
                continue
            c = dr.normalized_cfg(func, RollupConfig(
                rcfg0.start - 600_000, rcfg0.start + 600_000, 60_000,
                WINDOW))
            mean = dr.rollup_aggregate_tile(func, "avg", *whole, flat, c,
                                            off, mt)
            for aggr in dr.AGGR_FUNCS:
                fn = meshlib.cached_sharded_rollup_aggregate(mesh, func, aggr,
                                                             c, 5)
                got = fn(*shards, layouts, off, mt)
                what = f"B13 {func}/{aggr} shift {off}"
                mesh_close(what, aggr, got, dr.rollup_aggregate_tile(
                    func, aggr, *whole, flat, c, off, mt), func, mean)
                e = aggr_close(f"{what} plain", aggr, got, sharded_plain(
                    mesh, func, aggr, shards, layouts, c, off, mt), func,
                    mean)
                if aggr not in ("stddev", "stdvar") and \
                        func in dr.COUNTER_FUNCS:
                    err13 = max(err13, e)
    shards = [split_rows(mesh, "series", x) for x in (ts_t, v_t, counts)]
    gids = torch.arange(S, device=dev).remainder(G).to(torch.int32)
    layouts = [dr.group_layout(g, G, dev)
               for g in split_rows(mesh, "series", gids)]
    flat = dr.group_layout(gids, G, dev)
    # by instance (32 rows a group, 4 a shard) and one group (1024 rows a
    # shard, which each shard walks in chunks and folds)
    zeros = torch.zeros(S, dtype=torch.int32, device=dev)
    for g_, lays, fl in ((G, layouts, flat), (1, [
            dr.group_layout(g, 1, dev) for g in split_rows(
                mesh, "series", zeros)], dr.group_layout(zeros, 1, dev))):
        for aggr in dr.AGGR_FUNCS:
            got = meshlib.sharded_rollup_aggregate(mesh, "rate", aggr, cfg,
                                                   g_)(*shards, lays)
            mesh_close(f"B13 dashboard {g_} groups {aggr}", aggr, got,
                       dr.rollup_aggregate_tile("rate", aggr, ts_t, v_t,
                                                counts, fl, cfg))
    # the shards of one card run one row scan and one moments pass: one
    # launch of the wrapper, whose moments are each shard's rows walked in
    # order one add after another (no shard holds more than FLEET_CHUNK
    # members of a group), bit for bit
    before = kernels.LAUNCHES["rollup_group_moments"]
    for aggr in ("sum", "stddev", "min", "max"):
        mom = dr.rollup_group_moments("rate", aggr, *shards, layouts, cfg)
        for d in range(MESH_SHARDS):
            assert_equal(f"B13 moments {aggr} shard {d}", mom[d],
                         sequential_moments(aggr, dr.rollup_tile(
                             "rate", *(x[d] for x in shards), cfg),
                             layouts[d]))
    if kernels.LAUNCHES["rollup_group_moments"] - before != 4:
        raise AssertionError("B13: the shards of one card took more than "
                             "one moments launch")
    b13 = meshlib.cached_sharded_rollup_aggregate(mesh, "rate", "sum", cfg,
                                                  G)
    res["sharded_rollup_aggregate"] = dict(
        max_abs_err=err13, ms=cuda_ms(lambda: b13(*shards, layouts)),
        plain_ms=cuda_ms(lambda: sharded_plain(
            mesh, "rate", "sum", shards, layouts, cfg), reps=3),
        library_ms=None, shards=MESH_SHARDS,
        k2_ms=cuda_ms(lambda: dr.rollup_aggregate_tile(
            "rate", "sum", ts_t, v_t, counts, flat, cfg)),
        **bound(n_valid * 12 + S * 12 + G * T * 8, 15 * S * T))

    # B14: kernels_fleet's bucket over 4 stream shards, and its bucket of
    # large groups (each shard's own layout chunks them as B9 does)
    (cfg0, layout, fts, fvals, fcnt, aggr, shift, min_ts, v0, fgids,
     fgids1) = bucket
    fmesh = meshlib.make_fleet_mesh([dev] * 4)
    sh = {k: split_rows(fmesh, "stream", x) for k, x in (
        ("ts", fts), ("vals", fvals), ("cnt", fcnt), ("aggr", aggr),
        ("shift", shift), ("min_ts", min_ts), ("v0", v0))}
    flay = [dr.fleet_layout(g, G, dev)
            for g in split_rows(fmesh, "stream", fgids)]
    flay1 = [dr.fleet_layout(g, 3, dev)
             for g in split_rows(fmesh, "stream", fgids1)]
    layout1 = dr.fleet_layout(fgids1, 3, dev)
    names = {code: name for name, code in dr.FLEET_AGGR_CODES.items()}
    err14 = 0.0
    for func in FLEET_FUNCS:
        c = dr.normalized_cfg(func, cfg0)
        fn1 = meshlib.cached_fleet_rollup_aggregate(fmesh, func, c, 3)
        assert_equal(f"B14 {func} large groups", fn1(
            sh["ts"], sh["vals"], sh["cnt"], flay1, sh["aggr"], sh["shift"],
            sh["min_ts"], sh["v0"]), dr.fleet_rollup_aggregate_tile(
            func, c, layout1, fts, fvals, fcnt, aggr, shift, min_ts, v0))
        fn = meshlib.cached_fleet_rollup_aggregate(fmesh, func, c, G)
        got = fn(sh["ts"], sh["vals"], sh["cnt"], flay, sh["aggr"],
                 sh["shift"], sh["min_ts"], sh["v0"])
        args9 = (func, c, layout, fts, fvals, fcnt, aggr, shift, min_ts, v0)
        assert_equal(f"B14 {func}", got, dr.fleet_rollup_aggregate_tile(
            *args9))
        want = dr.fleet_rollup_aggregate_tile_plain(*args9)
        for b in range(FLEET_LIVE):
            name = names[int(aggr[b])]
            e = aggr_close(f"B14 {func} slot {b}", name, got[b], want[b],
                           func)
            if name not in ("stddev", "stdvar"):
                err14 = max(err14, e)
    c = dr.normalized_cfg("rate", cfg0)
    fn = meshlib.cached_fleet_rollup_aggregate(fmesh, "rate", c, G)
    B, S9, _ = fts.shape
    T9 = dr.num_steps(c)
    res["cached_fleet_rollup_aggregate"] = dict(
        max_abs_err=err14, shards=4,
        ms=cuda_ms(lambda: fn(sh["ts"], sh["vals"], sh["cnt"], flay,
                              sh["aggr"], sh["shift"], sh["min_ts"],
                              sh["v0"]), reps=5),
        plain_ms=cuda_ms(lambda: dr.fleet_rollup_aggregate_tile_plain(
            "rate", c, layout, fts, fvals, fcnt, aggr, shift, min_ts, v0),
            reps=3),
        library_ms=None,
        b9_ms=cuda_ms(lambda: dr.fleet_rollup_aggregate_tile(
            "rate", c, layout, fts, fvals, fcnt, aggr, shift, min_ts, v0),
            reps=5),
        **bound(int(fcnt.sum()) * 12 + B * S9 * 20 + B * (G + 1) * 4 +
                B * 12 + B * G * T9 * 8, 15 * B * S9 * T9))

    # B15 over the dashboard tile's first DASH_SAMPLES columns, rebased to
    # the first scrape so the grid's chunks line up with the columns: gaps
    # in the first time shard, in the second one's halo (the first one's
    # tail) and in the second shard itself, so that both sources, rows
    # read in place and compacted rows, run on the card
    base = T_START - start
    ts15 = ts_t[:, :DASH_SAMPLES] - base
    v15 = v_t[:, :DASH_SAMPLES].contiguous()
    C15 = DASH_SAMPLES // B15_MESH[1]
    valid = torch.ones_like(ts15, dtype=torch.bool)
    valid[::7, 100:103] = False  # gaps
    valid[1::5, C15 - 5:C15 - 2] = False
    valid[2::9, C15 + 3] = False
    mesh15 = meshlib.make_mesh(*B15_MESH, [dev] * MESH_SHARDS)
    parts = [meshlib.split_2d(mesh15, x) for x in (ts15, v15, valid)]
    cfg15 = RollupConfig(0, DASH_SAMPLES * SCRAPE - B15_STEP, B15_STEP,
                         WINDOW)
    # B5's view of the same samples: the valid ones compacted per row
    order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
    ts5 = torch.where(valid, ts15, int(dr.TS_PAD)).gather(1, order)
    v5 = torch.where(valid, v15, 0.0).gather(1, order)
    c5 = valid.sum(dim=1).to(torch.int32)
    err15 = 0.0
    for halo in (B15_HALO, C15):  # H = C: the halo is the whole shard
        for func in dr.FUNC_CODES:
            if func == "lifetime" or (halo == C15 and func not in (
                    "rate", "timestamp", "deriv", "stddev_over_time")):
                continue
            step = meshlib.time_sharded_rollup(mesh15, func, cfg15, halo)
            got = step(*parts)
            want = dr.rollup_tile(func, ts5, v5, c5, cfg15)
            if not bool(torch.isfinite(got).any()):
                raise AssertionError(f"B15 {func}: no finite value")
            # stddev/stdvar_over_time centre by the row mean, which a time
            # shard takes over its own samples (the reference's
            # semantics): they are held at the reference oracle's bound
            assert_close(f"B15 {func} halo {halo} vs B5", got, want,
                         *((1e-6, 1e-4) if func in dr.CENTRED_FUNCS
                           else (1e-9, 1e-9)))
            e = func_close(f"B15 {func} halo {halo} plain", func, got,
                           meshlib.time_sharded_rollup_plain(
                               mesh15, func, cfg15, halo)(*parts))
            if func in dr.COUNTER_FUNCS:
                err15 = max(err15, e)
        # one launch per phase for the card's 8 shards, at most one sync
        for func in ("rate", "timestamp"):
            check_b15_phases(f"B15 {func} halo {halo}", func,
                             meshlib.time_sharded_rollup(
                                 mesh15, func, cfg15, halo), parts, 1)
    # the halo pass itself: every row's source against the plain
    # transcription, both sources on the card
    halo15 = {h: check_halo_rows(f"halo {h}", mesh15, parts, h, cfg15)
              for h in (B15_HALO, C15)}
    step = meshlib.time_sharded_rollup(mesh15, "rate", cfg15, B15_HALO)
    T15 = dr.num_steps(cfg15)
    res["time_sharded_rollup"] = dict(
        max_abs_err=err15, mesh=list(B15_MESH), halo=B15_HALO,
        halo_rows=halo15,
        ms=cuda_ms(lambda: step(*parts)), device_ms=device_ms(
            lambda: step(*parts)),
        plain_ms=cuda_ms(lambda: meshlib.time_sharded_rollup_plain(
            mesh15, "rate", cfg15, B15_HALO)(*parts), reps=3),
        library_ms=None,
        b5_ms=cuda_ms(lambda: dr.rollup_tile("rate", ts5, v5, c5, cfg15)),
        **bound(S * DASH_SAMPLES * 13 + S * T15 * 8, 15 * S * T15))
    return res



def k1_edge_planes(rng, S: int, n: int, d2type, dev) -> list:
    """K1's arguments for S rows of n columns: random first values, first
    deltas and d2 entries of `d2type` in a plane 5 columns wider than
    n - 2; row 0 has count 0 and scale 1 (a mesh's padded row), row 1 a
    linear tail that wraps int32 at once, the rest counts in [0, n]."""
    info = np.iinfo(d2type)
    lo, hi = max(int(info.min), -2**20), min(int(info.max), 2**20)
    d2 = [rng.integers(lo, hi + 1, (S, max(n - 2, 1) + 5)).astype(d2type)
          for _ in range(2)]
    first = [rng.integers(-2**31, 2**31, S).astype(np.int32)
             for _ in range(4)]
    scale = 10.0 ** rng.integers(-6, 4, S).astype(np.float64)
    counts = rng.integers(0, n + 1, S).astype(np.int32)
    counts[0], scale[0] = 0, 1.0
    for x in first:
        x[1] = 2_000_000_000
    d2[0][1] = d2[1][1] = 0
    return [torch.from_numpy(a).to(dev) for a in (
        first[0], first[1], d2[0], first[2], first[3], d2[1], scale, counts)]


@contextlib.contextmanager
def k1_chunk(chunk: int):
    """decode_tiles inside the block cuts its rows in chunks of `chunk`
    columns, whatever k1_plan would pick."""
    keep = dd.k1_plan
    dd.k1_plan = lambda n, tb, vb, *_: dd.K1Plan(chunk,
                                                 dd.k1_smem(chunk, tb, vb))
    try:
        yield
    finally:
        dd.k1_plan = keep


def check_k1_edges(dev) -> None:
    """K1 bit for bit against its plain version at its edge rows: n of 1,
    2 and odd widths, each d2 width, planes wider than n - 2, count-0 rows
    and wrapping tails; planes at an offset from a 16-byte word; rows
    wider than one chunk (int32 planes at 7233 columns, which k1_plan cuts
    in two) and rows forced into other chunks, so b and x carry from chunk
    to chunk."""
    rng = np.random.default_rng(10)
    for n in (1, 2, 3, 5, 1857, 7233):
        for d2type in (np.int8, np.int16, np.int32):
            a = k1_edge_planes(rng, 64, n, d2type, dev)
            g, w = dd.decode_tiles(*a, n), dd.decode_tiles_plain(*a, n)
            what = f"K1 edge n={n} {d2type.__name__}"
            assert_equal(f"{what} ts", g[0], w[0])
            assert_equal(f"{what} values", g[1], w[1])
    if dd.k1_plan(7233, 4, 4, kernels.smem_per_sm(dev)).chunk >= 7233:
        raise AssertionError("K1: 7233 int32 columns are not chunked")
    # planes that start 1 to 15 bytes past a 16-byte word (views into a
    # buffer that ends with them): staged with no byte outside them
    for n, off in ((1857, 1), (38, 7), (7233, 15)):
        a = k1_edge_planes(rng, 64, n, np.int8, dev)
        for i in (2, 5):
            buf = torch.empty(off + a[i].numel(), dtype=torch.int8,
                              device=dev)
            a[i] = buf[off:].view(a[i].shape).copy_(a[i])
        g, w = dd.decode_tiles(*a, n), dd.decode_tiles_plain(*a, n)
        assert_equal(f"K1 planes at +{off} B, n={n} ts", g[0], w[0])
        assert_equal(f"K1 planes at +{off} B, n={n} values", g[1], w[1])
    a = k1_edge_planes(rng, 64, 1000, np.int16, dev)
    w = dd.decode_tiles_plain(*a, 1000)
    for chunk in (96, 7, 999, 1000):
        with k1_chunk(chunk):
            g = dd.decode_tiles(*a, 1000)
        assert_equal(f"K1 chunk {chunk} ts", g[0], w[0])
        assert_equal(f"K1 chunk {chunk} values", g[1], w[1])


def phase_kernels(rng, dev):
    """Each kernel against its plain version on the card: the dashboard
    shapes (timed), ragged edge-case rows and a fleet bucket.  Returns the
    timed kernels' results and the fleet kernels' largest differences."""
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
    edge_planes = []  # (plane tensors, columns), B12's edge rows too
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
        edge_planes.append((a, nc))
    check_k1_edges(dev)
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
        for func in dr.FUNC_CODES:
            if off and func in dr.TIME_VALUED_FUNCS:
                continue  # they refuse a shifted grid
            rcfg = dr.normalized_cfg(func, rcfg0)
            mean = dr.rollup_aggregate_tile_plain(func, "avg", tsr, vr, cr,
                                                  rgroups, rcfg, off, mt)
            for aggr in dr.AGGR_FUNCS:
                g = dr.rollup_aggregate_tile(func, aggr, tsr, vr, cr,
                                             rgroups, rcfg, off, mt)
                w = dr.rollup_aggregate_tile_plain(func, aggr, tsr, vr, cr,
                                                   rgroups, rcfg, off, mt)
                if not bool(torch.isnan(g[4]).all()):
                    raise AssertionError("K2: the empty group is not NaN")
                e = aggr_close(f"K2 {func}/{aggr} shift {off}", aggr, g, w,
                               func, mean)
                if aggr not in ("stddev", "stdvar") and \
                        func in dr.COUNTER_FUNCS:
                    err2 = max(err2, e)
    T = dr.num_steps(cfg)
    n_valid = int(counts.sum())
    # K2's staged windows against B5's global searches: count, group, min
    # and max of rate (with resets too) and deriv, plain and rolling grids,
    # equal to B5's rows under the plain aggregate
    for func, vals in (("rate", v_t), ("rate", v_reset), ("deriv", v_t)):
        for sh, mt in ((0, int(dr.MIN_TS_NONE)), roll):
            rolled = dr.rollup_tile(func, ts_t, vals, counts, cfg, mt, sh)
            for aggr in ("count", "group", "min", "max"):
                assert_same_values(
                    f"K2 {func}/{aggr} shift {sh} vs B5",
                    dr.rollup_aggregate_tile(func, aggr, ts_t, vals, counts,
                                             groups, cfg, sh, mt),
                    dr.aggregate_groups(aggr, rolled, groups.gids,
                                        DASH_GROUPS))
    # K2 over groups it walks in chunks of R = FLEET_CHUNK: one group of
    # every series, and groups of exactly R, R + 1 and 2R + 1 members
    # beside one of the rest, members scattered over the tile; every
    # aggregate of rate: count, group, min and max equal to B5's rows
    # under the plain aggregate, the others against the chunked plain
    # version at aggr_close's tolerances
    R = dr.FLEET_CHUNK
    perm = rng.permutation(DASH_SERIES)
    edge = np.full(DASH_SERIES, 3, np.int32)
    edge[perm[:R]], edge[perm[R:2 * R + 1]] = 0, 1
    edge[perm[2 * R + 1:4 * R + 2]] = 2
    g_one = dr.group_layout(np.zeros(DASH_SERIES, np.int32), 1, dev)
    g_edge = dr.group_layout(edge, 4, dev)
    if g_edge.slots != 2 + 3 + -(-(DASH_SERIES - 4 * R - 2) // R):
        raise AssertionError(f"K2 chunk edges: {g_edge.slots} slots")
    rolled = dr.rollup_tile("rate", ts_t, v_t, counts, cfg)
    for what, lay in (("one group", g_one), ("R, R+1, 2R+1", g_edge)):
        for aggr in dr.AGGR_FUNCS:
            got = dr.rollup_aggregate_tile("rate", aggr, ts_t, v_t, counts,
                                           lay, cfg)
            if aggr in ("count", "group", "min", "max"):
                assert_same_values(f"K2 {what} {aggr} vs B5", got,
                                   dr.aggregate_groups(aggr, rolled, lay.gids,
                                                       lay.num_groups))
                continue
            e = aggr_close(f"K2 {what} {aggr}", aggr, got,
                           dr.rollup_aggregate_tile_plain(
                               "rate", aggr, ts_t, v_t, counts, lay, cfg))
            if aggr not in ("stddev", "stdvar"):
                err2 = max(err2, e)
    del rolled
    # sum(rate) over one group of every series: timed beside the
    # by-instance query (the same tile, 128 chunks of 64 rows)
    k2_one = lambda: dr.rollup_aggregate_tile(  # noqa: E731
        "rate", "sum", ts_t, v_t, counts, g_one, cfg)
    if not bool(torch.isfinite(k2_one()).all()):
        raise AssertionError("K2 dashboard one group: non-finite rates")
    res["rollup_aggregate_tile"] = dict(
        max_abs_err=err2, ms=cuda_ms(k2), plain_ms=cuda_ms(k2_plain, reps=3),
        ms_with_resets=cuda_ms(k2_resets),
        one_group={**three_ms(k2_one, n=10, reps=5), **bound(
            n_valid * 12 + DASH_SERIES * 12 + T * 8, 15 * DASH_SERIES * T)},
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
    res.update(kernels_slice2(rng, dev, ts_t, v_t, counts, ragged))
    fleet_err, b9_k2_bitwise, bucket = kernels_fleet(rng, dev, ts_t, v_t,
                                                     counts)
    res.update(kernels_mesh(dev, (args, n_cap), edge_planes,
                            (ts_t, v_t, counts), ragged, bucket))
    for r in res.values():
        r["bound_ms"] = max(r["bytes"] / MEM_BYTES_PER_S,
                            r["ops"] / SCALAR_OPS_PER_S) * 1e3
        r["bound_by"] = "bytes" if r["bytes"] / MEM_BYTES_PER_S >= \
            r["ops"] / SCALAR_OPS_PER_S else "operations"
    emit({"phase": "kernels", "ok": True,
          "shapes": {"series": DASH_SERIES, "tile_cols": n_cap,
                     "steps": T, "groups": DASH_GROUPS},
          "kernels": res, "fleet_max_abs_err": fleet_err,
          "b9_vs_k2_bitwise": b9_k2_bitwise,
          "uploads": uploads})
    return res, fleet_err


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


# the dashboard's other panels on the cold query's resident tile: (field,
# entry point, arguments after the engine); each is held against the same
# entry point on a CPU engine, which runs the plain versions
# kernels each slice-2 query must launch on the card
QUERY_KERNELS = {
    "rate": ("rollup_tile",),
    "topk": ("rollup_tile", "topk_select_tile", "take_rows"),
    "bottomk": ("rollup_tile", "topk_select_tile", "take_rows"),
    "topk_avg": ("rollup_tile", "rank_tile", "take_rows"),
    "topk_median": ("rollup_tile", "rank_tile", "take_rows"),
    "topk_last": ("rollup_tile", "rank_tile", "take_rows"),
    "quantile_by_instance": ("rollup_tile", "rollup_quantile_tile"),
    "median": ("rollup_tile", "rollup_quantile_tile"),
    "avg_deriv_by_instance": ("rollup_aggregate_tile",),
    "instant_quantile": ("rollup_tile", "rollup_quantile_tile"),
}


def check_launched(where: str, name: str, launches: dict) -> None:
    missing = [k for k in QUERY_KERNELS[name] if launches.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"{where} {name}: {missing} not launched")


def dashboard_panels(engine, series, cfg, key, gids) -> dict:
    """Per-series rates, top/bottom 10, the topk_<kind> rankings and the
    quantile panels as cold queries on the resident tile: wall ms, launches
    and the largest difference from the plain versions, per query."""
    S, G = len(series), DASH_GROUPS
    _, max_group = ce.group_slots(gids, G)
    ones = np.zeros(S, np.int32)
    queries = {
        "rate": (ce.try_rollup, ("rate", series, cfg, ())),
        "topk": (ce.try_topk_rollup, ("topk", 10, "rate", series, cfg)),
        "bottomk": (ce.try_topk_rollup, ("bottomk", 10, "rate", series,
                                         cfg)),
        "topk_avg": (ce.try_topk_rollup, ("topk_avg", 10, "rate", series,
                                          cfg)),
        "topk_median": (ce.try_topk_rollup, ("topk_median", 10, "rate",
                                             series, cfg)),
        "topk_last": (ce.try_topk_rollup, ("topk_last", 10, "rate", series,
                                           cfg)),
        "quantile_by_instance": (ce.try_quantile_rollup, (
            0.9, "rate", series, gids, G, cfg, max_group)),
        "median": (ce.try_quantile_rollup, (0.5, "rate", series, ones, 1,
                                            cfg, S)),
    }
    cpu = ce.CUDAEngine(device="cpu")
    cpu.cache().put_device(key, tuple(t.cpu() for t in
                                      engine.cache().get(key)))
    out = {}
    for name, (fn, args) in queries.items():
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        got = fn(engine, *args, cache_key=key)
        wall = time.perf_counter() - t0
        launches = {k: v - before.get(k, 0)
                    for k, v in kernels.LAUNCHES.items()
                    if v != before.get(k, 0)}
        check_launched("dashboard", name, launches)
        want = fn(cpu, *args, cache_key=key)
        if got is None or want is None:
            raise AssertionError(f"dashboard {name}: declined")
        if fn is ce.try_topk_rollup:
            if [i for i, _ in got] != [i for i, _ in want] or not got:
                raise AssertionError(f"dashboard {name}: other series")
            got = np.stack([r for _, r in got])
            want = np.stack([r for _, r in want])
        got, want = np.asarray(got), np.asarray(want)
        if not np.isfinite(got).any():
            raise AssertionError(f"dashboard {name}: no finite value")
        err = assert_close(f"dashboard {name}", torch.from_numpy(got),
                           torch.from_numpy(want), 1e-12, 0.0)
        out[name] = {"ms": wall * 1e3, "shape": list(got.shape),
                     "launches": launches, "max_abs_err_vs_plain": err}
    return out


def dashboard_keys():
    """The dashboard query's roll-state and roll-tile keys, and its group
    keys."""
    return ce.device_roll_keys(SELECTOR, None, "rate", "sum", None,
                               ("instance",), False, None, WINDOW), \
        [(("instance", f"host-{g}"),) for g in range(DASH_GROUPS)]


def phase_dashboard(rng, dev):
    """The main path: cold query, then rolling refreshes, each held
    against a cold rebuild.  Returns the phase's result and the state the
    fleet phase continues from (store, engine, keys, the last end)."""
    S, G = DASH_SERIES, DASH_GROUPS
    # room for the dashboard's refreshes and the fleet phase's intervals
    extra = sum(k for k, _ in DASH_REFRESHES + FLEET_INTERVALS)
    store = SynthStorage(rng, S, DASH_SAMPLES, DASH_SAMPLES + extra)
    # the mesh phase replays the same store and ingests on a copy
    replay = copy.deepcopy(store)
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
    panels = dashboard_panels(engine, series,
                              RollupConfig(start, end, DASH_STEP, WINDOW),
                              key, gids)
    _, max_group = ce.group_slots(gids, G)
    (skey, tkey), group_keys = dashboard_keys()
    rt = ce.register_window(
        engine, skey, tkey, gids, group_keys, tile_key=key, series=series,
        cfg=RollupConfig(start, end, DASH_STEP, WINDOW),
        fetch_info=(fetch_lo, end, ver0),
        structural=store.structural_version)
    if rt is None:
        raise AssertionError("dashboard: the rolling window was not filed")
    refresh_ms, refresh_up, refresh_split, worst = [], [], [], 0.0
    quantile_ms, worst_q, served_all = [], 0.0, []
    compactions0 = _metric_sum("vm_device_window_compactions_total")
    for k, adv in DASH_REFRESHES:
        store.ingest(k, end)
        start, end = start + adv, end + adv
        fetch_lo = start - WINDOW - LOOKBACK_DELTA
        up0 = tile_cache.bytes_uploaded()
        snap, fetch0 = split_snapshot(), store.fetch_s
        t0 = time.perf_counter()
        rt, groups, _ = engine.window_cache().get(skey)
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
        served_all.append(served)
        refresh_up.append(tile_cache.bytes_uploaded() - up0)
        refresh_split.append(split_ms(snap, split_snapshot(), wall,
                                      {"fetch": store.fetch_s - fetch0}))
        tile_cache.count_window_hit()
        # the quantile panel on the same refreshed tile, timed on its own
        t0 = time.perf_counter()
        served_q = ce.run_quantile_on_tiles(engine, 0.9, "rate", rt.tiles,
                                            groups, cfg, start - rt.base_ms,
                                            fetch_lo - start)
        quantile_ms.append((time.perf_counter() - t0) * 1e3)
        before = dict(kernels.LAUNCHES)
        eng2 = ce.CUDAEngine(device=dev)
        rebuilt, series2 = cold(start, end, eng2)
        rebuilt_q = ce.try_quantile_rollup(eng2, 0.9, "rate", series2, gids,
                                           G, cfg, max_group)
        for name, n in kernels.LAUNCHES.items():
            rebuild_launches[name] = rebuild_launches.get(name, 0) + \
                n - before.get(name, 0)
        worst = max(worst, assert_close("served == cold", served, rebuilt,
                                        1e-12, 0.0))
        if not np.isfinite(served_q).all():
            raise AssertionError("rolling quantile: non-finite result")
        worst_q = max(worst_q, assert_close(
            "served quantile == cold", served_q, rebuilt_q, 1e-12, 0.0))
    launches = {name: kernels.LAUNCHES.get(name, 0) -
                rebuild_launches.get(name, 0) for name in SOURCES
                if name not in FLEET_KERNELS + MESH_KERNELS}
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
           "served_vs_cold_max_abs_err": worst,
           "quantile_refresh_ms": quantile_ms,
           "quantile_served_vs_cold_max_abs_err": worst_q,
           "panels": panels, "launches": launches}
    emit(res)
    return res, {"store": store, "engine": engine, "end": end,
                 "replay": {"store": replay, "cold": out,
                            "served": served_all}}

class StandingQuery:
    """One subscribed dashboard panel as the fleet reads it (the
    reference's matstream, duck-typed): grid, tenant, parsed shape, and
    due() until its interval is served."""

    def __init__(self, q: str, step: int, duration: int,
                 shape: fleet.StreamShape):
        self.q, self.step, self.duration, self.shape = q, step, duration, shape
        self.tenant = None
        self.end = None

    def due(self, now_ms: int) -> bool:
        return self.end is None or now_ms // self.step * self.step > self.end


class FleetAPI:
    """What FleetPlane.run reads of a serving front end: the storage and
    the standing queries."""

    def __init__(self, storage, engine, streams):
        self.storage, self.engine, self._streams = storage, engine, streams
        self.matstreams = self

    def streams(self):
        return list(self._streams)


FLEET_SPLIT = {
    "h2d": SPLIT["h2d"], "d2h": SPLIT["d2h"],
    "append": 'vm_tpu_kernel_duration_seconds_sum{kernel="fleet_append_tile"',
    "compact":
        'vm_tpu_kernel_duration_seconds_sum{kernel="fleet_compact_tile"',
    "launch": 'vm_tpu_kernel_duration_seconds_sum'
              '{kernel="fleet_rollup_aggregate_tile"',
}


def _fleet_bound_b9(b) -> dict:
    """B9's least time on bucket `b` (timing.fleet_bound)."""
    return fleet_bound(int(b.counts_h.sum()), b.B_pad, b.S_b, b.G_b, b.T_b)


def _b9_args(b, now, dev) -> tuple:
    """B9's arguments for bucket `b` at the grid ending `now`."""
    shift = np.zeros(b.B_pad, np.int32)
    min_ts = np.zeros(b.B_pad, np.int32)
    for m in b.members:
        shift[m.slot] = now - m.duration - m.base_ms
        min_ts[m.slot] = -(m.lookback + m.lookback_delta)
    d = b.dev
    return (b.func, b.cfg, d["layout"], d["ts"], d["vals"], d["counts"],
            d["aggr"], torch.from_numpy(shift).to(dev),
            torch.from_numpy(min_ts).to(dev), d["v0"])


def fleet_events(plane, buckets, now, next_cutoff) -> dict:
    """B9, B10 and B11 on real buckets, CUDA-event timed beside their plain
    versions and each held against it: B9 on the grid-A buckets of rate by
    instance and of rate with no grouping (this interval's grid), B10 a
    steady interval's columns and B11 the resume's slide on the grid-B
    bucket of rate by instance."""
    out = {}
    a, one, bb = buckets
    dev = plane.engine.device
    args = _b9_args(a, now, dev)
    got, want = dr.fleet_rollup_aggregate_tile(*args), \
        dr.fleet_rollup_aggregate_tile_plain(*args)
    err = 0.0
    for m in a.members:
        e = aggr_close(f"B9 bucket A {m.aggr}", m.aggr, got[m.slot],
                       want[m.slot], a.func)
        if m.aggr not in ("stddev", "stdvar"):
            err = max(err, e)
    args1 = _b9_args(one, now, dev)
    out["fleet_rollup_aggregate_tile"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: dr.fleet_rollup_aggregate_tile(*args), reps=5),
        plain_ms=cuda_ms(lambda: dr.fleet_rollup_aggregate_tile_plain(
            *args), reps=3), library_ms=None,
        shape=[a.B_pad, a.S_b, a.N_b, a.G_b, a.T_b],
        ms_one_group=cuda_ms(lambda: dr.fleet_rollup_aggregate_tile(*args1),
                             reps=5),
        bound_ms_one_group=_fleet_bound_b9(one)["bound_ms"],
        # ms, device_ms and host_ms of both buckets, and the one-group
        # bucket's chunks per group (FLEET_CHUNK members each)
        by_instance=three_ms(lambda: dr.fleet_rollup_aggregate_tile(*args),
                             n=10, reps=5),
        one_group=three_ms(lambda: dr.fleet_rollup_aggregate_tile(*args1),
                           n=10, reps=5),
        chunks_one_group=dr.fleet_chunks(args1[2]),
        shape_one_group=[one.B_pad, one.S_b, one.N_b, one.G_b, one.T_b],
        **_fleet_bound_b9(a))
    # B10 on scratch copies of bucket B's planes, restored before each call
    d = bb.dev
    B, S, N = bb.B_pad, bb.S_b, bb.N_b
    K = 8
    cnt = d["counts"]
    new_ts = (d["ts"].gather(2, (cnt.long() - 1).clamp(min=0)[..., None]) +
              SCRAPE * (1 + torch.arange(K, device=dev))).to(torch.int32)
    new_vals = torch.rand((B, S, K), dtype=torch.float64, device=dev,
                          generator=torch.Generator(dev).manual_seed(4))
    new_counts = torch.zeros((B, S), dtype=torch.int32, device=dev)
    new_counts[:len(bb.members)] = 4  # a steady interval's 4 scrapes
    bufs = [torch.empty_like(t) for t in (d["ts"], d["vals"], cnt)]

    def fresh():
        for buf, t in zip(bufs, (d["ts"], d["vals"], cnt)):
            buf.copy_(t)

    fresh()
    got = [t.clone() for t in dr.fleet_append_tile(*bufs, new_ts, new_vals,
                                                   new_counts)]
    fresh()
    want = dr.fleet_append_tile_plain(*bufs, new_ts, new_vals, new_counts)
    for g, w, what in zip(got, want, ("ts", "values", "counts")):
        assert_equal(f"B10 bucket B {what}", g, w)
    n_new = int(new_counts.sum())
    out["fleet_append_tile"] = dict(
        max_abs_err=0.0, ms=cuda_ms(lambda: dr.fleet_append_tile(
            *bufs, new_ts, new_vals, new_counts), setup=fresh),
        plain_ms=cuda_ms(lambda: dr.fleet_append_tile_plain(
            *bufs, new_ts, new_vals, new_counts), setup=fresh, reps=3),
        library_ms=None, shape=[B, S, N, K],
        **bound(n_new * 12 * 2 + B * S * 12, n_new))
    del got, want, bufs
    # B11 at the cutoffs the resume will slide bucket B's members to
    cut = torch.zeros(B, dtype=torch.int32)
    for m in bb.members:
        cut[m.slot] = next_cutoff(m) - m.base_ms
    cut = cut.to(dev)
    got = dr.fleet_compact_tile(d["ts"], d["vals"], cnt, cut, cut)
    want = dr.fleet_compact_tile_plain(d["ts"], d["vals"], cnt, cut, cut)
    for g, w, what in zip(got, want, ("ts", "values", "counts")):
        assert_equal(f"B11 bucket B {what}", g, w)
    survivors = int(got[2].sum())
    dropped = int(cnt.sum()) - survivors
    del got, want
    out["fleet_compact_tile"] = dict(
        max_abs_err=0.0, ms=cuda_ms(lambda: dr.fleet_compact_tile(
            d["ts"], d["vals"], cnt, cut, cut)),
        plain_ms=cuda_ms(lambda: dr.fleet_compact_tile_plain(
            d["ts"], d["vals"], cnt, cut, cut), reps=3),
        library_ms=None, shape=[B, S, N],
        **bound(survivors * 12 + dropped * 4 + B * S * N * 12 + B * S * 8 +
                B * 8, B * S * N))
    return out


def phase_fleet(rng, dev, state) -> dict:
    """Fleet-batched serving on the dashboard's store and resident
    selector: 128 standing queries adopted into 16 buckets, six intervals
    through FleetPlane.run, each stream held against the per-stream path
    on the selector's own rolling tile (grid A's streams first: their fetch
    bound is the oldest, so the per-stream advance never slides the tile
    past it)."""
    store, engine = state["store"], state["engine"]
    (_, tkey), inst_keys = dashboard_keys()
    rt = engine.window_cache().get(tkey)
    S, G = DASH_SERIES, DASH_GROUPS
    inst = (np.arange(S) % G).astype(np.int32)
    # by instance (or without id), and one group of every series
    layouts = ((inst, inst_keys, dr.group_layout(inst, G, dev)),
               (np.zeros(S, np.int32), [()],
                dr.group_layout(np.zeros(S, np.int32), 1, dev)))
    streams = []
    for grid, (dur, step, groupings) in FLEET_GRIDS.items():
        for func in FLEET_FUNCS:
            for aggr in dr.FLEET_AGGR_CODES:
                for (grouping, without), (gids, keys, groups) in zip(
                        groupings, layouts):
                    shape = fleet.StreamShape(
                        selector=SELECTOR, filters=None, func=func,
                        aggr=aggr, window=WINDOW, grouping=grouping,
                        without=without, lookback_delta=LOOKBACK_DELTA)
                    q = f"{aggr} {'without' if without else 'by'} " \
                        f"({','.join(grouping)})({func}({SELECTOR}[5m]))"
                    st = StandingQuery(q, step, dur, shape)
                    skey, _ = ce.device_roll_keys(
                        SELECTOR, None, func, aggr, None, grouping, without,
                        None, WINDOW)
                    if ce.register_window(engine, skey, tkey, gids,
                                          keys) is not rt:
                        raise AssertionError("fleet: window not filed")
                    streams.append((st, skey, groups, grid))
    api = FleetAPI(store, engine, [st for st, *_ in streams])
    plane = engine.fleet()
    torch.cuda.reset_peak_memory_stats(dev)
    now = -(-(state["end"] + FLEET_INTERVALS[0][1]) // 60_000) * 60_000
    intervals, worst, events = [], 0.0, None
    launches = dict.fromkeys(FLEET_KERNELS, 0)
    adoption_up = 0
    for i, (k, adv) in enumerate(FLEET_INTERVALS):
        if i:
            now += adv
        if i == len(FLEET_INTERVALS) - 1:
            # before the resume: B9-B11 timed on real buckets
            by = {(b.func, b.G_b, b.step): b
                  for b in plane._buckets.values()}
            one = fleet.bucket_up(1)  # the no-grouping buckets' groups
            events = fleet_events(
                plane, (by["rate", G, 60_000], by["rate", one, 60_000],
                        by["rate", G, SCRAPE]),
                now - adv,
                lambda m, t=now: t - m.duration - m.lookback -
                m.lookback_delta)
        store.ingest(k, now - adv)
        before = dict(kernels.LAUNCHES)
        up0 = tile_cache.bytes_uploaded()
        snap = {key: _metric_sum(n) for key, n in FLEET_SPLIT.items()}
        fetch0 = store.fetch_s
        adopt0 = plane.adopt_s
        t0 = time.perf_counter()
        n = plane.run(api, now)
        wall = time.perf_counter() - t0
        up = tile_cache.bytes_uploaded() - up0
        split = {f"{key}_ms": (_metric_sum(m) - snap[key]) * 1e3
                 for key, m in FLEET_SPLIT.items()}
        split["fetch_ms"] = (store.fetch_s - fetch0) * 1e3
        # the rest: host staging, and in the adoption interval the
        # adoptions' host crops (adopt_ms holds each adoption's pull, whose
        # bytes d2h_ms counts, and its crop)
        split["stage_ms"] = wall * 1e3 - sum(split.values())
        split["adopt_ms"] = (plane.adopt_s - adopt0) * 1e3
        ran = {k2: kernels.LAUNCHES.get(k2, 0) - before.get(k2, 0)
               for k2 in FLEET_KERNELS}
        for k2 in FLEET_KERNELS:
            launches[k2] += ran[k2]
        stats = plane.stats()
        if n != stats["buckets"] or n != ran["fleet_rollup_aggregate_tile"] \
                or stats["members"] != len(streams) or stats["evictions"]:
            raise AssertionError(f"fleet interval {i}: {n} launches, "
                                 f"{ran}, {stats}, {plane.last_decline}")
        if i == 0:
            adoption_up = up
        # the per-stream path: the selector's own rolling tile
        t0 = time.perf_counter()
        means = {}
        for st, skey, groups, grid in streams:
            sh = st.shape
            start = now - st.duration
            fetch_lo = start - sh.window - LOOKBACK_DELTA
            if not ce.advance_rolling(engine, rt, store, None, start,
                                      fetch_lo, now, None, None, True):
                raise AssertionError("fleet oracle declined: "
                                     + engine.last_roll_decline)
            cfg = RollupConfig(start, now, st.step, sh.window)
            want = ce.run_fused_on_tiles(engine, sh.aggr, sh.func, rt.tiles,
                                         groups, cfg, start - rt.base_ms,
                                         fetch_lo - start)
            if sh.aggr == "avg":
                means[grid, sh.func, sh.grouping] = want
            r = plane._results[skey]
            if r.end != now or r.rows.shape != want.shape:
                raise AssertionError(f"fleet {st.q}: no result for {now}")
            # the group mean, for the variance's 16-ulp term (avg comes
            # before stddev and stdvar)
            mean = means.get((grid, sh.func, sh.grouping))
            e = aggr_close(f"fleet interval {i} {st.q}", sh.aggr,
                           torch.from_numpy(r.rows), torch.from_numpy(want),
                           sh.func,
                           None if mean is None else torch.from_numpy(mean))
            if sh.aggr not in ("stddev", "stdvar"):
                worst = max(worst, e)
            if not np.isfinite(r.rows).any():
                raise AssertionError(f"fleet {st.q}: no finite value")
            st.end = now
        oracle_s = time.perf_counter() - t0
        intervals.append({"scrapes": k, "fleet_ms": wall * 1e3,
                          "split": split, "upload_bytes": up,
                          "launches": ran, "per_stream_ms": oracle_s * 1e3})
    steady = [iv["upload_bytes"] for iv in intervals[1:-1]]
    if max(steady) * 20 > adoption_up:
        raise AssertionError("fleet: steady intervals uploaded too much")
    if launches["fleet_compact_tile"] < 1:
        raise AssertionError("fleet: the resume slid no bucket (B11)")
    buckets = sorted(plane._buckets.values(), key=lambda b: b.key)
    res = {"phase": "fleet", "ok": True, "streams": len(streams),
           "buckets": [{"func": b.func, "step": b.step, "B": b.B_pad,
                        "S": b.S_b, "N": b.N_b, "T": b.T_b, "G": b.G_b}
                       for b in buckets],
           "device_plane_bytes": sum(b.ts_h.nbytes + b.vals_h.nbytes
                                     for b in buckets),
           "adoptions": plane.adoptions,
           "adopt_ms_per_stream": plane.adopt_s / plane.adoptions * 1e3,
           "adoption_upload_bytes": adoption_up, "intervals": intervals,
           "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
           "fleet_vs_per_stream_max_abs_err": worst, "launches": launches,
           "kernels": events}
    emit(res)
    engine._fleet = None  # the planes and mirrors go before full width
    return res



def full_width_queries(engine, series, cfg, key, gids, G, dev) -> dict:
    """The slice-2 queries on the resident full-width tile, each with its
    own launch counts: topk(10, rate), topk_median(10, rate), avg by
    (instance)(deriv), and an instant quantile(0.99, rate) over every
    series at the range's end; then each held against the plain versions
    (rows in chunks, steps in chunks)."""
    S = len(series)
    ts_t, v_t, counts = engine.cache().get(key)
    ncfg = dr.normalized_cfg("rate", cfg)
    T = dr.num_steps(ncfg)
    t_end = cfg.end
    icfg = RollupConfig(t_end, t_end, FULL_STEP, WINDOW)
    shift, i_min_ts = t_end - cfg.start, -(WINDOW + LOOKBACK_DELTA)
    one = dr.group_layout(np.zeros(S, np.int32), 1, dev)
    queries = {
        "topk": (ce.try_topk_rollup, ("topk", 10, "rate", series, cfg),
                 {"cache_key": key}),
        "topk_median": (ce.try_topk_rollup, ("topk_median", 10, "rate",
                                             series, cfg),
                        {"cache_key": key}),
        "avg_deriv_by_instance": (ce.try_aggr_rollup, (
            "avg", "deriv", series, gids, G, cfg), {"cache_key": key}),
        "instant_quantile": (ce.run_quantile_on_tiles, (
            0.99, "rate", (ts_t, v_t, counts), one, icfg, shift, i_min_ts),
            {}),
    }
    out, got = {}, {}
    for name, (fn, args, kw) in queries.items():
        kernels.reset_launches()
        t0 = time.perf_counter()
        got[name] = fn(engine, *args, **kw)
        out[name] = {"ms": (time.perf_counter() - t0) * 1e3,
                     "launches": dict(kernels.LAUNCHES)}
        if got[name] is None:
            raise AssertionError(f"full width {name}: declined")
        check_launched("full width", name, out[name]["launches"])
    # the gate declines a full-width range quantile, as the reference's does
    if ce.quantile_dense_fits(engine, 1, S, cfg) or \
            ce.quantile_dense_fits(engine, G, S // G, cfg) or \
            ce.try_quantile_rollup(engine, 0.99, "rate", series,
                                   np.zeros(S, np.int32), 1, cfg, S,
                                   cache_key=key) is not None:
        raise AssertionError("full width: a range quantile was admitted")

    # checks, against the plain versions
    rolled = dr.rollup_tile("rate", ts_t, v_t, counts, ncfg)
    drv = torch.zeros((G, T), dtype=torch.float64, device=dev)
    drv_n = torch.zeros_like(drv)
    ranks = {k: dr.rank_rows(rolled, k) for k in dr.RANK_KINDS}
    rank = ranks["median"]
    chunk = 4096
    err5 = 0.0
    for r0 in range(0, S, chunk):
        sl = slice(r0, r0 + chunk)
        w = dr.rollup_tile_plain("rate", ts_t[sl], v_t[sl], counts[sl], ncfg)
        err5 = max(err5, func_close(f"full width B5 rows {r0}+", "rate",
                                    rolled[sl], w))
        # B7, every kind, as check_ranks holds them
        for k, r in ranks.items():
            w = dr.rank_rows_plain(rolled[sl], k)
            if k in ("median", "last"):
                assert_exact(f"full width B7 {k} rows {r0}+", r[sl], w)
            else:
                assert_close(f"full width B7 {k} rows {r0}+", r[sl], w,
                             1e-12 if k == "avg" else 0.0, 0.0)
        d = dr.rollup_tile_plain("deriv", ts_t[sl], v_t[sl], counts[sl],
                                 ncfg)
        live = ~torch.isnan(d)
        g = torch.from_numpy(gids[r0:r0 + chunk]).to(dev).long()
        drv.index_add_(0, g, torch.where(live, d, 0.0))
        drv_n.index_add_(0, g, live.double())
        del w, d, live
    aggr_close("full width K2 avg(deriv)", "avg",
               torch.from_numpy(got["avg_deriv_by_instance"]),
               (drv / drv_n).cpu(), "deriv")
    idx, sel_nan = dr.topk_select(rolled, 10, False)
    # k = 20, as k = 10, takes B6's scan path (k <= K_REG)
    idx20, nan20 = dr.topk_select(rolled, 20, False)
    for t0 in range(0, T, 512):
        wi, wn = dr.topk_select_plain(rolled[:, t0:t0 + 512].contiguous(),
                                      20, False)
        assert_equal(f"full width B6 steps {t0}+", idx[t0:t0 + 512],
                     wi[:, :10])
        assert_equal(f"full width B6 nan steps {t0}+",
                     sel_nan[t0:t0 + 512], wn[:, :10])
        assert_equal(f"full width B6 k=20 steps {t0}+", idx20[t0:t0 + 512],
                     wi)
        assert_equal(f"full width B6 k=20 nan steps {t0}+",
                     nan20[t0:t0 + 512], wn)
    del idx20, nan20, wi, wn
    # the sort path (k > K_REG) over all 100,000 rows: a 512-step slice
    part = rolled[:, :512].contiguous()
    k_sort = dr.K_REG + 1
    gi, gn = dr.topk_select(part, k_sort, False)
    wi, wn = dr.topk_select_plain(part, k_sort, False)
    assert_equal(f"full width B6 k={k_sort} 512 steps", gi, wi)
    assert_equal(f"full width B6 k={k_sort} nan 512 steps", gn, wn)
    del gi, gn, wi, wn
    want_sel = np.unique(idx.cpu().numpy()[~sel_nan.cpu().numpy()])
    if [i for i, _ in got["topk"]] != [int(i) for i in want_sel]:
        raise AssertionError("full width topk: other series")
    rank_h = rank.cpu().numpy()
    order = np.argsort(np.where(np.isnan(rank_h), -np.inf, rank_h),
                       kind="stable")
    if [i for i, _ in got["topk_median"]] != [int(i) for i in order[-10:]]:
        raise AssertionError("full width topk_median: other series")
    sel_t = torch.from_numpy(want_sel).to(dev)  # the panel's rows, int64
    b6 = {f"k{k}": three_ms(lambda k=k: dr.topk_select(rolled, k, False),
                            n=10, reps=3) for k in (10, 20)}
    b6[f"k{k_sort}_512_steps"] = three_ms(
        lambda: dr.topk_select(part, k_sort, False), n=3, reps=3)
    b6["plan_k10"] = dr.topk_plan(S, T, 10, kernels.sm_count(dev))._asdict()
    b6["bound_ms"] = topk_bound(S, T, 10)["bound_ms"]
    del part
    # library calls on the same inputs (the key pre-transposed, as at the
    # dashboard shape)
    key = dr._topk_key(rolled, False).T.contiguous()
    library = {f"topk_k{k}": library_or_oom(
        lambda k=k: torch.topk(key, k, dim=1), 10) for k in (10, 20)}
    del key
    library["index_select"] = library_or_oom(
        lambda: torch.index_select(rolled, 0, sel_t), 10)
    library["nanquantile_median"] = library_or_oom(
        lambda: torch.nanquantile(rolled, 0.5, dim=1), 3)
    events = {
        "rollup_tile_ms": cuda_ms(lambda: dr.rollup_tile(
            "rate", ts_t, v_t, counts, ncfg), reps=3),
        "topk_select_ms": b6["k10"]["ms"],
        "topk_select_k20_ms": b6["k20"]["ms"],
        "topk_select": b6,
        "take_rows": {"rows": int(sel_t.numel()), **three_ms(
            lambda: dr.take_rows(rolled, sel_t), n=10, reps=3),
            **take_rows_bound(int(sel_t.numel()), T)},
        "rank_median_ms": cuda_ms(lambda: dr.rank_rows(rolled, "median"),
                                  reps=3),
        "rank_device_ms": {k: device_ms(lambda k=k: dr.rank_rows(rolled, k),
                                        5) for k in dr.RANK_KINDS},
        "nanmean_device_ms": device_ms(
            lambda: torch.nanmean(rolled, dim=1), 5),
        "k2_deriv_avg_ms": cuda_ms(lambda: dr.rollup_aggregate_tile(
            "deriv", "avg", ts_t, v_t, counts,
            dr.group_layout(gids, G, dev), ncfg), reps=3),
    }
    del rolled
    # the plain instant rollup on the CPU, where torch divides by a
    # scalar as the kernels do (on the card it multiplies by the
    # reciprocal, an ulp away): the engine's quantile and B5's rates are
    # held to it bit for bit
    cpu = torch.device("cpu")
    inst = torch.cat([dr.rollup_tile_plain(
        "rate", ts_t[r0:r0 + chunk].cpu() - shift, v_t[r0:r0 + chunk].cpu(),
        counts[r0:r0 + chunk].cpu(), dr.normalized_cfg("rate", icfg),
        i_min_ts) for r0 in range(0, S, chunk)])
    inst_k = dr.rollup_tile("rate", ts_t, v_t, counts,
                            dr.normalized_cfg("rate", icfg), i_min_ts, shift)
    assert_exact("full width instant rate", inst_k.cpu(), inst)
    q_plain = dr.quantile_groups_plain(
        inst, dr.group_layout(np.zeros(S, np.int32), 1, cpu), 0.99)
    assert_exact("full width instant quantile", torch.from_numpy(
        got["instant_quantile"]), q_plain)
    if not np.isfinite(got["instant_quantile"]).all():
        raise AssertionError("full width instant quantile: not finite")
    # B8's cluster path on the instant's one group of every series, bit
    # for bit at every phi
    events["instant_quantile_plan"] = check_quantile(
        "full width instant", inst_k, one,
        (dr.Q_CLUSTER, 16, 1) if S == 100_000 else None)
    events["instant_quantile_ms"] = cuda_ms(
        lambda: dr.quantile_groups(inst_k, one, 0.99), reps=3)
    events["instant_quantile"] = {
        **three_ms(lambda: dr.quantile_groups(inst_k, one, 0.99)),
        **quantile_bound(S, 1, 1)}
    dense = dr.dense_by_group(inst_k, one)
    library["nanquantile_instant"] = library_or_oom(
        lambda: torch.nanquantile(dense, 0.99, dim=1), 50)
    return {"queries": out, "event_ms": events, "library": library,
            "b5_max_abs_err_vs_plain": err5,
            "instant_quantile": float(got["instant_quantile"][0, 0])}


def decode_tap(planes: list):
    """Wrap dd.decode_tiles to keep the planes an engine hands K1; returns
    the restore function."""
    real = dd.decode_tiles

    def tap(*a):
        planes.append(a)
        return real(*a)

    dd.decode_tiles = tap
    return lambda: setattr(dd, "decode_tiles", real)


def full_width_b5(ts_t, v_t, counts, cfg, chunk: int) -> dict:
    """B5 on the full-width tile: rate, deriv and tlast_over_time on the
    plan's path (staged at this shape) against the global search bit for
    bit, compared in row chunks, and the device ms of each path."""
    S, N = ts_t.shape
    res = {}
    for func in ("rate", "deriv", "tlast_over_time"):
        c = dr.normalized_cfg(func, cfg)
        T = dr.num_steps(c)
        plan = dr.b5_plan(S, N, T, c.step, c.lookback,
                          dr.scrape_hint(N, T, c.step, c.lookback),
                          kernels.sm_count(ts_t.device))
        if plan.path != dr.K2_STAGED:
            raise AssertionError(f"full width B5 {func}: plan {plan} is "
                                 "not staged")
        got = dr.rollup_tile(func, ts_t, v_t, counts, c)
        for r0 in range(0, S, chunk):
            sl = slice(r0, r0 + chunk)
            assert_equal(f"full width B5 {func} rows {r0}+ plan vs global",
                         got[sl], dr.rollup_tile(func, ts_t[sl], v_t[sl],
                                                 counts[sl], c,
                                                 force_global=True))
        del got
        res[func] = {"plan": plan._asdict(), "device_ms": device_ms(
            lambda: dr.rollup_tile(func, ts_t, v_t, counts, c), 3),
            "global_device_ms": device_ms(lambda: dr.rollup_tile(
                func, ts_t, v_t, counts, c, force_global=True), 3)}
        torch.cuda.empty_cache()
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
    restore = decode_tap(planes)
    snap = split_snapshot()
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        out = ce.try_aggr_rollup(engine, "sum", "rate", series, gids, G, cfg,
                                 cache_key=key)
    finally:
        restore()
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
    k1_device_ms = device_ms(lambda: dd.decode_tiles(*args, n_cap), n=3)
    uploads = upload_paths(
        "full_width_planes", [a.cpu().numpy() for a in args], dev, reps=3)
    del planes  # `args` stay for the mesh phase's B12
    groups = dr.group_layout(gids, G, dev)
    ncfg = dr.normalized_cfg("rate", cfg)
    k2_ms = cuda_ms(lambda: dr.rollup_aggregate_tile(
        "rate", "sum", ts_t, v_t, counts, groups, ncfg), reps=3)
    # plain version in row chunks: per-chunk rollup, summed by group
    cnt = torch.zeros((G, T), dtype=torch.float64, device=dev)
    s1 = torch.zeros_like(cnt)
    for r0 in range(0, S, chunk):
        sl = slice(r0, r0 + chunk)
        rolled = dr.rollup_tile_plain("rate", ts_t[sl], v_t[sl], counts[sl],
                                      ncfg)
        present = ~torch.isnan(rolled)
        g = groups.gids[sl].long()
        cnt.index_add_(0, g, present.double())
        s1.index_add_(0, g, torch.where(present, rolled, 0.0))
        del rolled, present
    plain = torch.where(cnt > 0, s1, torch.nan)
    err = assert_close("full width K2 vs plain", torch.from_numpy(out),
                       plain.cpu(), 1e-12, 0.0)
    del cnt, s1, plain
    # K2's staged windows (512-step tiles here) against B5's global
    # searches: count, group, min and max of rate and deriv equal B5's rows
    # under the plain aggregate, folded over row chunks
    for func in ("rate", "deriv"):
        want = {}
        for r0 in range(0, S, chunk):
            sl = slice(r0, r0 + chunk)
            rolled = dr.rollup_tile(func, ts_t[sl], v_t[sl], counts[sl], ncfg)
            m = dr.partial_group_moments("min", rolled, groups.gids[sl], G)
            m["max"] = dr.partial_group_moments("max", rolled,
                                                groups.gids[sl], G)["max"]
            for k, x in m.items():
                want[k] = x if k not in want else \
                    torch.minimum(want[k], x) if k == "min" else \
                    torch.maximum(want[k], x) if k == "max" else want[k] + x
            del rolled, m
        for aggr in ("count", "group", "min", "max"):
            assert_same_values(
                f"full width K2 {func}/{aggr} vs B5",
                dr.rollup_aggregate_tile(func, aggr, ts_t, v_t, counts, groups,
                                         ncfg),
                dr.finalize_group_moments(aggr, want))
        del want
    b5 = full_width_b5(ts_t, v_t, counts, cfg, chunk)
    slice2 = full_width_queries(engine, series, cfg, key, gids, G, dev)
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
           "k1_bitwise_vs_plain": True, "k1_device_ms": k1_device_ms,
           "k1_plan": dd.k1_plan(n_cap, args[2].element_size(),
                                 args[5].element_size(),
                                 kernels.smem_per_sm(dev))._asdict(),
           "max_abs_err_vs_plain": err,
           "uploads": uploads, "b5": b5, "slice2": slice2}
    emit(res)
    return res, {"engine": engine, "series": series, "cfg": cfg,
                 "gids": gids, "key": key, "out": out, "N": N,
                 "planes": (args, n_cap)}


class Aside:
    """Launches made beside the mesh path (the unsharded comparisons and
    the cold rebuilds): `with aside():` records them so the path's counts
    leave them out."""

    def __init__(self):
        self.n = collections.Counter()

    @contextlib.contextmanager
    def __call__(self):
        before = dict(kernels.LAUNCHES)
        try:
            yield
        finally:
            for k, v in kernels.LAUNCHES.items():
                self.n[k] += v - before.get(k, 0)


def mesh_dashboard(dev, replay, aside) -> dict:
    """(a): the dashboard's cold query and six refreshes through an
    engine on MESH_SHARDS logical shards, against an unsharded engine on
    the same replayed store (whose sum equals phase_dashboard's results bit
    for bit) and against cold rebuilds.  Returns the part's result and the
    state (d) and (e) continue from."""
    store = replay["store"]
    S, G = DASH_SERIES, DASH_GROUPS
    gids = (np.arange(S) % G).astype(np.int32)
    start, end = dashboard_grid()
    mesh = meshlib.make_mesh(MESH_SHARDS, 1, [dev] * MESH_SHARDS)
    meng = ce.CUDAEngine(mesh=mesh)
    flat = ce.CUDAEngine(device=dev)

    def cold(eng, start_ms, end_ms, key=None):
        series = store.search_series(start_ms - WINDOW - LOOKBACK_DELTA,
                                     end_ms)
        cfg = RollupConfig(start_ms, end_ms, DASH_STEP, WINDOW)
        return ce.try_aggr_rollup(eng, "sum", "rate", series, gids, G, cfg,
                                  cache_key=key), series

    ver0 = store.data_version
    key = ("mesh-dashboard", start, ver0)
    snap = split_snapshot()
    t0 = time.perf_counter()
    got, series = cold(meng, start, end, key)
    cold_s = time.perf_counter() - t0
    cold_split = split_ms(snap, split_snapshot(), cold_s)
    planes = []
    restore = decode_tap(planes)
    try:
        with aside():
            want, _ = cold(flat, start, end, key)
    finally:
        restore()
    if not np.array_equal(want.view(np.int64), replay["cold"].view(np.int64)):
        raise AssertionError("mesh: the replayed store differs from the "
                             "dashboard phase's")
    cfg = RollupConfig(start, end, DASH_STEP, WINDOW)
    tiles = meng.cache().get(key)
    if len(tiles[0]) != MESH_SHARDS:
        raise AssertionError("mesh: the tile is not sharded")
    worst = {}

    def compare(what, served):
        """Every aggregate on both engines' tiles."""
        mean = None
        for aggr in dr.AGGR_FUNCS:
            g = served(meng, aggr)
            with aside():
                w = served(flat, aggr)
            e = mesh_close(f"mesh {what} {aggr}", aggr, g, w, "rate", mean)
            if aggr == "avg":
                mean = torch.from_numpy(w)
            worst[aggr] = max(worst.get(aggr, 0.0), e)

    compare("cold", lambda eng, aggr: ce.try_aggr_rollup(
        eng, aggr, "rate", series, gids, G, cfg, cache_key=key))
    (skey, tkey), group_keys = dashboard_keys()
    fetch_lo = start - WINDOW - LOOKBACK_DELTA
    for eng in (meng, flat):
        if ce.register_window(eng, skey, tkey, gids, group_keys,
                              tile_key=key, series=series, cfg=cfg,
                              fetch_info=(fetch_lo, end, ver0),
                              structural=store.structural_version) is None:
            raise AssertionError("mesh: the rolling window was not filed")
    refresh_ms, worst_cold, worst_q = [], 0.0, 0.0
    for i, (k, adv) in enumerate(DASH_REFRESHES):
        store.ingest(k, end)
        start, end = start + adv, end + adv
        fetch_lo = start - WINDOW - LOOKBACK_DELTA
        cfg = RollupConfig(start, end, DASH_STEP, WINDOW)
        rolled = {}
        for eng in (meng, flat):
            with contextlib.ExitStack() as stack:
                if eng is flat:
                    stack.enter_context(aside())
                t0 = time.perf_counter()
                rt, groups, _ = eng.window_cache().get(skey)
                if not ce.advance_rolling(eng, rt, store, None, start,
                                          fetch_lo, end, None, None, True):
                    raise AssertionError("mesh refresh declined: "
                                         + eng.last_roll_decline)
                rolled[eng is meng] = (rt, groups, ce.run_fused_on_tiles(
                    eng, "sum", "rate", rt.tiles, groups, cfg,
                    start - rt.base_ms, fetch_lo - start))
                if eng is meng:
                    refresh_ms.append((time.perf_counter() - t0) * 1e3)
        served = rolled[True][2]
        if not np.array_equal(rolled[False][2].view(np.int64),
                              replay["served"][i].view(np.int64)):
            raise AssertionError("mesh: the replayed refresh differs from "
                                 "the dashboard phase's")

        def on_tile(eng, aggr):
            rt, groups, _ = rolled[eng is meng]
            return ce.run_fused_on_tiles(eng, aggr, "rate", rt.tiles, groups,
                                         cfg, start - rt.base_ms,
                                         fetch_lo - start)

        compare(f"refresh {i}", on_tile)
        # the quantile panel: B5 per shard, B8 on the gathered rows
        rt, groups, _ = rolled[True]
        q = ce.run_quantile_on_tiles(meng, 0.9, "rate", rt.tiles, groups,
                                     cfg, start - rt.base_ms,
                                     fetch_lo - start)
        with aside():
            rtf, gf, _ = rolled[False]
            qf = ce.run_quantile_on_tiles(flat, 0.9, "rate", rtf.tiles, gf,
                                          cfg, start - rtf.base_ms,
                                          fetch_lo - start)
            rebuilt, _ = cold(ce.CUDAEngine(mesh=mesh), start, end)
        worst_q = max(worst_q, assert_exact(
            f"mesh quantile refresh {i}", torch.from_numpy(q),
            torch.from_numpy(qf)))
        worst_cold = max(worst_cold, assert_close(
            f"mesh served == cold {i}", served, rebuilt, 1e-12, 0.0))
    rt = meng.window_cache().get(tkey)
    return {"cold_ms": cold_s * 1e3, "cold_split": cold_split,
            "refresh_ms": refresh_ms, "appends": rt.appends,
            "max_abs_err_vs_unsharded": worst,
            "served_vs_cold_max_abs_err": worst_cold,
            "quantile_max_abs_err_vs_unsharded": worst_q}, {
        "mesh": mesh, "engine": meng, "flat": flat, "end": end,
        "store": store, "planes": planes[0], "cfg": cfg}


def mesh_fleet(dev, st, aside) -> dict:
    """(d): 16 standing queries (rate x the 8 aggregates x grid B's two
    groupings: 2 buckets of 8) through the mesh engine's fleet (an 8-way
    stream mesh: B14, and B10 / B11 per shard) and through an unsharded
    engine's, on the replayed store, every stream of every interval bit
    for bit."""
    store, meng = st["store"], st["engine"]
    S, G = DASH_SERIES, DASH_GROUPS
    (_, tkey), inst_keys = dashboard_keys()
    inst = (np.arange(S) % G).astype(np.int32)
    start, end = st["end"] - (DASH_SAMPLES - 1) * SCRAPE + 300_000, st["end"]
    flat = ce.CUDAEngine(device=dev)
    with aside():
        series = store.search_series(start - WINDOW - LOOKBACK_DELTA, end)
        cfg = RollupConfig(start, end, DASH_STEP, WINDOW)
        key = ("mesh-fleet", start)
        ce.try_aggr_rollup(flat, "sum", "rate", series, inst, G, cfg,
                           cache_key=key)
        skey0, _ = ce.device_roll_keys(SELECTOR, None, "rate", "sum", None,
                                       ("instance",), False, None, WINDOW)
        ce.register_window(flat, skey0, tkey, inst, inst_keys, tile_key=key,
                           series=series, cfg=cfg,
                           fetch_info=(start - WINDOW - LOOKBACK_DELTA, end,
                                       store.data_version),
                           structural=store.structural_version)
    dur, step, groupings = FLEET_GRIDS["B"]
    layouts = ((inst, inst_keys), (np.zeros(S, np.int32), [()]))
    sides = {True: [], False: []}
    for aggr in dr.FLEET_AGGR_CODES:
        for (grouping, without), (gids, keys) in zip(groupings, layouts):
            skey, _ = ce.device_roll_keys(SELECTOR, None, "rate", aggr, None,
                                          grouping, without, None, WINDOW)
            for eng in (meng, flat):
                if ce.register_window(eng, skey, tkey, gids, keys) is None:
                    raise AssertionError("mesh fleet: window not filed")
                shape = fleet.StreamShape(
                    selector=SELECTOR, filters=None, func="rate", aggr=aggr,
                    window=WINDOW, grouping=grouping, without=without,
                    lookback_delta=LOOKBACK_DELTA)
                sides[eng is meng].append((StandingQuery(
                    f"{aggr} ({grouping})", step, dur, shape), skey))
    apis = {m: FleetAPI(store, meng if m else flat, [q for q, _ in sides[m]])
            for m in (True, False)}
    planes = {True: meng.fleet(), False: flat.fleet()}
    now = -(-(end + MESH_FLEET_INTERVALS[0][1]) // 60_000) * 60_000
    wall_ms, launches = [], []
    for i, (k, adv) in enumerate(MESH_FLEET_INTERVALS):
        if i:
            now += adv
        store.ingest(k, now - adv)
        before = kernels.LAUNCHES.get("cached_fleet_rollup_aggregate", 0)
        t0 = time.perf_counter()
        n = planes[True].run(apis[True], now)
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(kernels.LAUNCHES.get(
            "cached_fleet_rollup_aggregate", 0) - before)
        with aside():
            nf = planes[False].run(apis[False], now)
        stats = planes[True].stats()
        # (two buckets at 256 groups; one of 16 when the groupings' group
        # counts share a ladder rung)
        if n != nf or n != stats["buckets"] or launches[-1] != n or \
                stats["members"] != 16 or stats["evictions"]:
            raise AssertionError(f"mesh fleet interval {i}: {n}/{nf} "
                                 f"launches, {stats}, "
                                 f"{planes[True].last_decline}")
        for b in planes[True]._buckets.values():
            if b.B_pad % MESH_SHARDS or len(b.dev["ts"]) != MESH_SHARDS:
                raise AssertionError("mesh fleet: a bucket is not stream-"
                                     "sharded")
        for (qm, skey), (qf, _) in zip(sides[True], sides[False]):
            rm, rf = planes[True]._results[skey], planes[False]._results[skey]
            if rm.end != now or not np.array_equal(
                    rm.rows.view(np.int64), rf.rows.view(np.int64)):
                raise AssertionError(f"mesh fleet interval {i} {qm.q}: "
                                     "differs from the unsharded fleet")
            if not np.isfinite(rm.rows).any():
                raise AssertionError(f"mesh fleet {qm.q}: no finite value")
            qm.end = qf.end = now
    return {"streams": 16, "buckets": len(planes[True]._buckets),
            "interval_ms": wall_ms, "b14_launches": launches,
            "bitwise_vs_unsharded": True}


def mesh_decode(dev, what, planes, cfg, aside, tiles=None,
                chunk=4096) -> dict:
    """(e): B12 on an engine's delta planes against K1 -> B5 (K1 run
    again, or the engine's decoded `tiles` where no append has touched
    them) bit for bit, and against its plain version on the first,
    middle and last row chunks (K1 and B5 are each held against theirs
    over every row elsewhere)."""
    args, n_cap = planes[:8], planes[8]
    ncfg = dr.normalized_cfg("rate", cfg)
    got = dd.decode_and_rollup("rate", *args, ncfg, n_cap)
    with aside():
        if tiles is None:
            tiles = (*dd.decode_tiles(*args, n_cap), args[7])
        want = dr.rollup_tile("rate", *tiles, ncfg)
    assert_equal(f"B12 {what} vs K1 -> B5", got, want)
    del want
    err = 0.0
    S = int(args[7].shape[0])
    for r0 in sorted({0, S // 2 // chunk * chunk, (S - 1) // chunk * chunk}):
        err = max(err, func_close(
            f"B12 {what} rows {r0}+", "rate", got[r0:r0 + chunk],
            dd.decode_and_rollup_plain(
                "rate", *(a[r0:r0 + chunk] for a in args), ncfg, n_cap)))
    del got
    b12 = lambda: dd.decode_and_rollup("rate", *args, ncfg,  # noqa: E731
                                       n_cap)
    k1_b5 = lambda: dr.rollup_tile(  # noqa: E731
        "rate", *dd.decode_tiles(*args, n_cap), args[7], ncfg)
    with aside():
        ms = cuda_ms(b12, reps=3)
        k1_b5_ms = cuda_ms(k1_b5, reps=3)
        dev_ms = device_ms(b12, 5)
        k1_b5_dev_ms = device_ms(k1_b5, 5)
    return {"max_abs_err_vs_plain": err, "rows": S, "cols": int(n_cap),
            "steps": dr.num_steps(ncfg), "ms": ms, "k1_then_b5_ms": k1_b5_ms,
            "device_ms": dev_ms, "k1_then_b5_device_ms": k1_b5_dev_ms}


def mesh_full_width(dev, fw, aside) -> tuple[dict, dict]:
    """(b) the full-width cold query through the sharded engine, against
    the full_width phase's K2 (and every other aggregate on both resident
    tiles), and (c) B15 on a (2, 4) mesh over the full-width tile's
    columns against B5."""
    S, G = FULL_SERIES, FULL_SERIES // FULL_PER_GROUP
    flat, series, cfg, gids, key = (fw[k] for k in ("engine", "series",
                                                    "cfg", "gids", "key"))
    mesh = meshlib.make_mesh(MESH_SHARDS, 1, [dev] * MESH_SHARDS)
    meng = ce.CUDAEngine(mesh=mesh, cache_bytes=64 << 30)
    snap = split_snapshot()
    t0 = time.perf_counter()
    out = ce.try_aggr_rollup(meng, "sum", "rate", series, gids, G, cfg,
                             cache_key=key)
    total = time.perf_counter() - t0
    split = split_ms(snap, split_snapshot(), total)
    aggr_close("mesh full width sum", "sum", torch.from_numpy(out),
               torch.from_numpy(fw["out"]))
    worst = {}
    mean = None
    for aggr in dr.AGGR_FUNCS:
        g = ce.try_aggr_rollup(meng, aggr, "rate", series, gids, G, cfg,
                               cache_key=key)
        with aside():
            w = ce.try_aggr_rollup(flat, aggr, "rate", series, gids, G, cfg,
                                   cache_key=key)
        worst[aggr] = mesh_close(f"mesh full width {aggr}", aggr, g, w,
                                 "rate", mean)
        if aggr == "avg":
            mean = torch.from_numpy(w)
    ts_s, v_s, c_s = meng.cache().get(key)
    groups = ce.groups_for(meng, gids, G)
    ncfg = dr.normalized_cfg("rate", cfg)
    fn = meshlib.cached_sharded_rollup_aggregate(mesh, "rate", "sum", ncfg,
                                                 G)
    with aside():
        b13_ms = cuda_ms(lambda: fn(ts_s, v_s, c_s, groups.shards), reps=3)
    del ts_s, v_s, c_s, groups, meng
    b = {"total_ms": total * 1e3, "split": split, "b13_event_ms": b13_ms,
         "max_abs_err_vs_unsharded": worst}
    # (c) B15 over the tile's first N columns (every sample valid)
    ts_t, v_t, counts = flat.cache().get(key)
    if not bool((counts == fw["N"]).all()):
        raise AssertionError("full width: rows of unequal length")
    # columns in 4 chunks whose grids line up with B15_STEP: N % 16 == 0
    N = fw["N"] // 16 * 16
    mesh15 = meshlib.make_mesh(*B15_MESH, [dev] * MESH_SHARDS)
    valid = torch.ones((S, N), dtype=torch.bool, device=dev)
    parts = [meshlib.split_2d(mesh15, x)
             for x in (ts_t[:, :N], v_t[:, :N], valid)]
    cfg15 = RollupConfig(0, N * SCRAPE - B15_STEP, B15_STEP, WINDOW)
    c = {}
    for func in ("rate", "timestamp"):
        step = meshlib.time_sharded_rollup(mesh15, func, cfg15, B15_HALO)
        got = step(*parts)
        with aside():
            want = dr.rollup_tile(func, ts_t, v_t, counts, cfg15)
        if not bool(torch.isfinite(got[:, WINDOW // B15_STEP + 1:]).all()):
            raise AssertionError(f"full width B15 {func}: not finite")
        c[func] = {"max_abs_err_vs_b5": assert_close(
            f"full width B15 {func}", got, want, 1e-9, 1e-9),
            "calls": check_b15_phases(f"full width B15 {func}", func, step,
                                      parts, 1)}
        del got, want
    step = meshlib.time_sharded_rollup(mesh15, "rate", cfg15, B15_HALO)
    with aside():
        c["rate"]["ms"] = cuda_ms(lambda: step(*parts), reps=3)
        c["rate"]["device_ms"] = device_ms(lambda: step(*parts), 5)
        c["rate"]["b5_ms"] = cuda_ms(lambda: dr.rollup_tile(
            "rate", ts_t, v_t, counts, cfg15), reps=3)
    c.update(mesh=list(B15_MESH), halo=B15_HALO, step=B15_STEP,
             steps=dr.num_steps(cfg15), cols=N)
    return b, c


def phase_mesh(dev, replay, fw) -> dict:
    """The mesh phase, (a)-(e), every shard on `dev`.  Its launch counts
    leave out the unsharded comparisons and the cold rebuilds."""
    t_phase = time.perf_counter()
    aside = Aside()
    kernels.reset_launches()
    walls = {}

    def part(name, fn, *a):
        t0 = time.perf_counter()
        try:
            return fn(*a)
        finally:
            walls[name] = time.perf_counter() - t0

    dash, st = part("dashboard", mesh_dashboard, dev, replay, aside)
    fl = part("fleet", mesh_fleet, dev, st, aside)
    e = {"dashboard": part("decode_dashboard", mesh_decode, dev, "dashboard",
                           st["planes"], st["cfg"], aside)}
    del st
    b, c = part("full_width", mesh_full_width, dev, fw, aside)
    e["full_width"] = part(
        "decode_full_width", mesh_decode, dev, "full width",
        fw["planes"][0] + (fw["planes"][1],), fw["cfg"], aside,
        fw["engine"].cache().get(fw["key"]))
    launches = {k: kernels.LAUNCHES.get(k, 0) - aside.n.get(k, 0)
                for k in SOURCES}
    for name in MESH_KERNELS + ("decode_tiles", "append_tile",
                                "compact_tile", "fleet_append_tile",
                                "fleet_compact_tile"):
        if launches[name] < 1:
            raise AssertionError(f"mesh: {name} not launched on the path")
    res = {"phase": "mesh", "ok": True, "shards": MESH_SHARDS,
           "wall_s": time.perf_counter() - t_phase, "part_wall_s": walls,
           "dashboard": dash,
           "fleet": fl, "full_width": b, "time_sharded": c,
           "decode_and_rollup": e, "launches": launches}
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
    kres, fleet_err = phase_kernels(rng, dev)
    dash, dash_state = phase_dashboard(rng, dev)
    replay = dash_state.pop("replay")
    fl = phase_fleet(rng, dev, dash_state)
    del dash_state
    for name in FLEET_KERNELS:
        kres[name] = {**fl["kernels"][name], "max_abs_err": max(
            fleet_err[name], fl["kernels"][name]["max_abs_err"])}
    _, fw = phase_full_width(rng, dev, args.full_hours)
    mesh = phase_mesh(dev, replay, fw)
    del replay, fw
    # B1-B8 count on the dashboard path, B9-B11 on the fleet's, B12-B15 on
    # the mesh phase's
    launches = {**dash["launches"], **fl["launches"],
                **{k: mesh["launches"][k] for k in MESH_KERNELS}}
    for name in SOURCES:
        if launches.get(name, 0) < 1:
            raise AssertionError(f"{name} never launched on its path")
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": launches[name],
         "max_abs_err": kres[name]["max_abs_err"], "ms": kres[name]["ms"],
         "plain_ms": kres[name]["plain_ms"],
         "bound_ms": kres[name]["bound_ms"],
         "bound_by": kres[name]["bound_by"],
         "library_ms": kres[name].get("library_ms")}
        for name in SOURCES]})
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
