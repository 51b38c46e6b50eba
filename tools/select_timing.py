#!/usr/bin/env python3
"""Time B5 rollup_tile, B12 decode_and_rollup, K2 and B13, B6 topk_select
and take_rows, B7 rank_rows, B8 quantile_groups, B9
fleet_rollup_aggregate_tile, B15 time_sharded_rollup, K1 decode_tiles and
K3 append_tile / B10 fleet_append_tile, and
the PyTorch calls that compute the same functions where there is one, on
one CUDA card.

    python3 tools/select_timing.py [--root DIR] [--parts P,...] [--seed N]
                                   [--label L]

  ms         CUDA events around one call, median of 10 after a warm-up
             (the span includes the wrapper's host time whenever the
             card waits for it)
  device_ms  events around a run of back-to-back calls, over their count
             (median of 3 runs)
  host_ms    the host time of one call with no synchronise: a run of
             calls after a synchronise, over their count

These are chip_smoke.py's methods (victoriametrics_tpu_torch/timing.py of
this checkout, whichever checkout the port comes from).

The rolled tiles are rate(m[5m]) of jittered 15 s counters made on the
card from the seed and rolled by the port's own B5 rollup_tile: 8192
series x 1440 samples at step 60 s (the dashboard, 355 steps) and
100,000 x 5760 at step 15 s (BASELINE.md config 2, 5761 steps).
chip_smoke.py holds these kernels against their plain versions at both
shapes; this script only times them.  Where the port has B6's plan
(``topk_plan``), the scan path is also timed at every cluster size, its
picks held against the plan's, beside the plan's choice.  B8 runs at
the main path's three shapes beside torch.nanquantile on the reference's
dense [G, M, T]: the dashboard's quantile by instance (M = 32) and median
without by (M = 8192) and the full width's instant quantile (one group of
100,000, its last step).  B9 runs on two fleet buckets of 8 streams x
8192 jittered counters x 2048 columns, 384 steps of 60 s: grouped by
instance (256 groups of 32) and one group of every row (8 groups, the
fleet's padding), with their bounds, and the one-group bucket at each
chunk R of B9 (``FLEET_CHUNK``); K2 sum(rate) over one group of the
dashboard tile beside them.  K2 rollup_aggregate_tile and B13
sharded_rollup_aggregate (8 logical shards of the card) are timed on the
raw tiles at four shapes: sum(rate) by instance and in one group at the
dashboard, sum(rate) and avg(deriv) by instance at the full width (3125
groups of 32); each call's device_ms, and its split: every launch of the
rollup and mesh libraries timed alone by CUDA events (``launch_split``),
so the row scan (vm_rollup_scan), the scratch pass (vm_rollup_prep, when
a row needs it), the group pass (vm_rollup_groups) and B13's passes and
combine show apart, in either checkout.
B5 rollup_tile is timed on the raw tiles: rate and tlast_over_time at
the dashboard, rate and deriv at the full width, each call's device_ms and
launch split beside its bound, and, where the port has B5's plan
(``b5_plan``), the same call forced onto the global search.  B12
decode_and_rollup (rate) runs on delta planes made on the card from the
same tiles at the engine's tile capacity (int16 timestamp and int8 value
second differences, scale 1, zero-padded to tile_capacity(N) columns: 1856
at the dashboard, 7232 at the full width; K1 rebuilds the tiles from them
bit for bit), beside K1 alone and K1 then B5, and split into its phases
by diagnostic builds of the checkout's csrc/rollup.cu that end each row
after a phase (``-DVM_B12_STOP=1``: the decode; ``=2``: the row scan and
scratch too; the full kernel less those is the series pass).
B15 time_sharded_rollup (rate and timestamp on a (2, 4) mesh of 8
logical shards of the card, halo 32, steps of 60 s) runs over 1440
columns of 8192 counters with gaps in every seventh row and over the full
width's 100,000 x 5760, all valid: device_ms, ms and host_ms, each launch
timed alone, its host syncs (every Tensor.item), the gap between its
device time and its launches' sum, and B5 over the same valid samples on
the same grid.  B7 rank_tile runs its five kinds on both rolled tiles
(three ways each), avg beside torch.nanmean and the median beside
torch.nanquantile, the median's phases from diagnostic builds of the
checkout's csrc/select.cu (``-DVM_B7_STOP=1``: staged; ``=2``: the radix
passes; a source without the hooks, whose median is one block_select
then block_min_above, is patched at two anchors).
K1 decode_tiles runs on B12's delta planes (int16 and int8), with the
value plane widened to int16 and both to int32 (K1 chunks these rows at
the full width), device_ms beside its bound, and, for a port with K1's
plan (``k1_plan``), with its rows forced into other chunks.  K3 append_tile (the
dashboard's refresh: [8192, 1856], K 8, one new sample a row) and B10
fleet_append_tile (the fleet's steady interval, [8, 8192, 384], K 8, four
a row, and its 30-minute resume, K 120) run in place on a tile restored
before each call, each call alone between CUDA events after a device
sleep, beside a one-element PyTorch add timed the same way: the launch
floor.
``--root`` imports the port from another checkout (a parent commit
unpacked under a gitignored directory), so two versions compare in one
chip call: parent, change, change, parent.  ``--parts`` picks what runs
(default: every part).  Prints one JSON line with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

T_START, SCRAPE, JITTER, WINDOW = 1_753_700_000_000, 15_000, 2_000, 300_000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: what --parts picks from
PARTS = ("b5", "b12", "k2", "topk", "quantile", "b9", "b15", "b7", "k1",
         "b10")


def load_timing():
    """victoriametrics_tpu_torch/timing.py of this checkout, the timing
    method chip_smoke.py uses, loaded by path: it imports no port code, so
    the port itself can come from another checkout (--root)."""
    path = os.path.join(REPO, "victoriametrics_tpu_torch", "timing.py")
    spec = importlib.util.spec_from_file_location("select_timing_clock", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def counter_tile(dev, gen, shape, N: int, base: int):
    """Jittered 15 s counters of N samples, [*shape, N], timestamps
    relative to `base`; returns (ts, values, counts)."""
    jit = torch.randint(-JITTER, JITTER + 1, (*shape, N), generator=gen,
                        device=dev, dtype=torch.int32)
    ts = (torch.arange(N, device=dev, dtype=torch.int32) * SCRAPE) + \
        jit + int(base)
    del jit
    vals = torch.randint(0, 50, (*shape, N), generator=gen, device=dev,
                         dtype=torch.int64).cumsum_(-1).to(torch.float64)
    counts = torch.full(shape, N, dtype=torch.int32, device=dev)
    return ts, vals, counts


def rate_tile(dr, RollupConfig, dev, gen, S: int, N: int, start: int,
              end: int, step: int, k2=None) -> torch.Tensor:
    """rate(m[5m]) of S jittered counters of N samples from T_START; `k2`,
    when given, is called with the tile and the grid first."""
    ts, vals, counts = counter_tile(dev, gen, (S,), N, T_START - start)
    cfg = dr.normalized_cfg("rate", RollupConfig(start, end, step, WINDOW))
    if k2 is not None:
        k2(ts, vals, counts, cfg)
    return dr.rollup_tile("rate", ts, vals, counts, cfg)


def quantile_times(tm, dr, rolled: torch.Tensor, groups: int, phi: float,
                   n: int) -> dict:
    """B8 over `groups` groups of rolled's rows (row % groups) beside
    torch.nanquantile on the reference's dense [G, M, T]."""
    S, T = rolled.shape
    dev = rolled.device
    gids = (torch.arange(S, device=dev) % groups).to(torch.int32)
    layout = dr.group_layout(gids, groups, dev)
    dense = dr.dense_by_group(rolled, layout)
    out = {"S": S, "T": T, "G": groups, "M": layout.max_group,
           **tm.three_ms(lambda: dr.quantile_groups(rolled, layout, phi), n),
           "library": tm.three_ms(
               lambda: torch.nanquantile(dense, phi, dim=1), n),
           "bound_ms": tm.quantile_bound(S, T, groups)["bound_ms"]}
    if hasattr(dr, "quantile_plan"):  # a port with B8's plan
        out["plan"] = dr.quantile_plan(groups, T, layout.max_group)._asdict()
    return out


def fleet_times(tm, dr, RollupConfig, dev, gen, n: int) -> dict:
    """B9 on a bucket of 8 streams x 8192 counters x 2048 columns (1440
    samples), 384 steps of 60 s, grouped by instance and as one group."""
    B, S, N, T = 8, 8192, 2048, 384
    ts = torch.full((B, S, N), 2**31 - 1, dtype=torch.int32, device=dev)
    vals = torch.zeros((B, S, N), dtype=torch.float64, device=dev)
    t, v, counts = counter_tile(dev, gen, (B, S), 1440, 0)
    ts[..., :1440], vals[..., :1440] = t, v
    del t, v
    cfg = RollupConfig(0, (T - 1) * 60_000, 60_000, WINDOW)
    aggr = torch.zeros(B, dtype=torch.int32, device=dev)  # sum
    shift = (torch.arange(B, device=dev, dtype=torch.int32) % 4) * SCRAPE
    min_ts = torch.full((B,), -2 * WINDOW, dtype=torch.int32, device=dev)
    v0 = torch.zeros((B, S), dtype=torch.float64, device=dev)
    out = {}
    for name, G, gids in (("by_instance", 256, torch.arange(S) % 256),
                          ("one_group", 8, torch.zeros(S))):
        layout = dr.fleet_layout(
            gids.to(torch.int32)[None].expand(B, S).contiguous(), G, dev)
        out[name] = {
            "shape": [B, S, N, G, T],
            **tm.three_ms(lambda: dr.fleet_rollup_aggregate_tile(
                "rate", cfg, layout, ts, vals, counts, aggr, shift, min_ts,
                v0), n, reps=5),
            "bound_ms": tm.fleet_bound(int(counts.sum()), B, S, G, T)[
                "bound_ms"]}
        if hasattr(dr, "fleet_chunks"):  # a port with B9's chunks
            out[name]["chunks"] = dr.fleet_chunks(layout)
    if hasattr(dr, "FLEET_CHUNK"):
        out["chunk_sweep"] = chunk_sweep(tm, dr, cfg, ts, vals, counts,
                                         shift, min_ts, v0, n)
    return out


def chunk_sweep(tm, dr, cfg, ts, vals, counts, shift, min_ts, v0,
                n: int) -> dict:
    """device_ms of B9 on the one-group bucket at each chunk R (the
    layout built with FLEET_CHUNK = R), its counts held equal to R =
    FLEET_CHUNK's: what FLEET_CHUNK is tuned on."""
    B, S = counts.shape
    dev = ts.device
    gids = torch.zeros((B, S), dtype=torch.int32, device=dev)
    sum_, count = (torch.full((B,), dr.FLEET_AGGR_CODES[a], device=dev,
                              dtype=torch.int32) for a in ("sum", "count"))
    plan = dr.FLEET_CHUNK
    out = {"plan": plan}
    want = dr.fleet_rollup_aggregate_tile(
        "rate", cfg, dr.fleet_layout(gids, 8, dev), ts, vals, counts, count,
        shift, min_ts, v0)
    try:
        for r in (16, 32, 64, 128, 256, S):
            dr.FLEET_CHUNK = r
            layout = dr.fleet_layout(gids, 8, dev)
            got = dr.fleet_rollup_aggregate_tile(
                "rate", cfg, layout, ts, vals, counts, count, shift, min_ts,
                v0)
            if not torch.equal(got.view(torch.int64), want.view(torch.int64)):
                raise AssertionError(f"B9 chunk {r}: other counts")
            out[f"chunk{r}"] = tm.device_ms(
                lambda: dr.fleet_rollup_aggregate_tile(
                    "rate", cfg, layout, ts, vals, counts, sum_, shift,
                    min_ts, v0), n)
    finally:
        dr.FLEET_CHUNK = plan
    return out


# a device sleep before each timed launch, so its events span the
# kernel and not the host's launch: ~60 us at the H100's boost clock
_SLEEP_CYCLES = 100_000


class _TimedLib:
    """A loaded kernel library whose vm_* calls each run between two CUDA
    events, after a device sleep that keeps the card busy while the host
    launches; `spans` collects (name, start, end)."""

    def __init__(self, lib, spans: list):
        self._lib, self._spans = lib, spans

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if not name.startswith("vm_") or name == "vm_cuda_error_string":
            return fn

        def timed(*args):
            torch.cuda._sleep(_SLEEP_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            rc = fn(*args)
            b.record()
            self._spans.append((name, a, b))
            return rc
        return timed


@contextlib.contextmanager
def _timed_libs(kernels, names, spans):
    libs = {n: kernels.lib(n) for n in names}
    try:
        for n, h in libs.items():
            kernels._libs[n] = _TimedLib(h, spans)
        yield
    finally:
        kernels._libs.update(libs)


def launch_split(kernels, fn, reps: int = 5,
                 libs=("rollup", "mesh")) -> dict:
    """fn's launches of the `libs` libraries, each timed alone: per C
    entry point, its launches per call and the median over `reps` calls
    of their summed ms (the kernel's device time, whatever the wrapper's
    host time).  The wrapper's own host syncs run as always."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        spans = []
        with _timed_libs(kernels, libs, spans):
            fn()
        torch.cuda.synchronize()
        per = collections.defaultdict(lambda: [0, 0.0])
        for name, a, b in spans:
            per[name][0] += 1
            per[name][1] += a.elapsed_time(b)
        runs.append(per)
    return {name: {"calls": runs[0][name][0],
                   "ms": statistics.median(r[name][1] for r in runs)}
            for name in runs[0]}


def k2_times(tm, dr, kernels, meshlib, split_rows, ts, vals, counts, cfg,
             func: str, aggr: str, groups: int, n: int) -> dict:
    """K2 func/aggr over rows grouped by row % groups, and B13 on 8
    logical shards of the card (by instance only): device_ms, the launch
    split, the bound."""
    S = ts.shape[0]
    dev = ts.device
    gids = (torch.arange(S, device=dev) % groups).to(torch.int32)
    layout = dr.group_layout(gids, groups, dev)
    T = dr.num_steps(cfg)

    def k2():
        return dr.rollup_aggregate_tile(func, aggr, ts, vals, counts, layout,
                                        cfg)

    out = {"S": S, "N": ts.shape[1], "G": groups, "T": T,
           "device_ms": tm.device_ms(k2, n),
           "split": launch_split(kernels, k2),
           "bound_ms": tm.k2_bound(int(counts.sum()), S, groups, T)[
               "bound_ms"]}
    if hasattr(dr, "k2_plan"):  # a port with K2's staged plan
        N = ts.shape[1]
        out["plan"] = dr.k2_plan(
            S, N, T, cfg.step, cfg.lookback,
            dr.scrape_hint(N, T, cfg.step, cfg.lookback),
            kernels.sm_count(dev))._asdict()
    if groups == 1:
        return out
    mesh = meshlib.make_mesh(8, 1, [dev] * 8)
    shards = [split_rows(mesh, "series", x) for x in (ts, vals, counts)]
    layouts = [dr.group_layout(g, groups, dev)
               for g in split_rows(mesh, "series", gids)]
    b13 = meshlib.sharded_rollup_aggregate(mesh, func, aggr, cfg, groups)

    def run():
        return b13(*shards, layouts)

    out["b13"] = {"shards": 8, "device_ms": tm.device_ms(run, n),
                  "split": launch_split(kernels, run)}
    return out


def shape_times(tm, dr, rolled: torch.Tensor, ks, n: int) -> dict:
    S, T = rolled.shape
    out = {"S": S, "T": T, "topk": {}, "take_rows": {}}
    key = dr._topk_key(rolled, False).T.contiguous()
    for k in ks:
        reps = n if k <= 64 else max(n // 10, 3)
        out["topk"][str(k)] = {
            **tm.three_ms(lambda k=k: dr.topk_select(rolled, k, False), reps),
            "library": tm.three_ms(lambda k=k: torch.topk(key, k, dim=1),
                                   reps),
            "bound_ms": tm.topk_bound(S, T, k)["bound_ms"]}
    del key
    idx, _ = dr.topk_select(rolled, 10, False)
    sel = torch.unique(idx.long())
    M = int(sel.numel())
    for name, s in (("int64", sel), ("int32", sel.to(torch.int32))):
        out["take_rows"][name] = tm.three_ms(
            lambda s=s: dr.take_rows(rolled, s), n)
    out["take_rows"]["rows"] = M
    out["take_rows"]["library"] = tm.three_ms(
        lambda: torch.index_select(rolled, 0, sel), n)
    out["take_rows"]["bound_ms"] = tm.take_rows_bound(M, T)["bound_ms"]
    return out


def cluster_sweep(tm, dr, kernels, rolled, ks, clusters) -> dict:
    """device_ms of B6's scan path at each cluster size (rows split
    evenly), the plan's choice among them: what topk_plan is tuned on."""
    S, T = rolled.shape
    dev = rolled.device
    h = kernels.lib("select")
    out = {}
    for k in ks:
        want = dr.topk_select(rolled, k, False)
        idx = torch.empty((T, k), dtype=torch.int32, device=dev)
        nan = torch.empty((T, k), dtype=torch.bool, device=dev)
        for c in clusters:
            def run(c=c):
                kernels.check(h, h.vm_topk_select(
                    rolled.data_ptr(), S, T, k, 0, c, -(-S // c), 0, 0, None,
                    0, idx.data_ptr(), nan.data_ptr(),
                    kernels.stream_of(dev)), "topk_select_tile")
            run()
            if not (torch.equal(idx, want[0]) and torch.equal(nan, want[1])):
                raise AssertionError(f"B6 k={k} cluster {c}: other picks")
            out[f"k{k}_cluster{c}"] = tm.device_ms(run, 20)
        out[f"k{k}_plan"] = dr.topk_plan(S, T, k,
                                         kernels.sm_count(dev)).cluster
    return out


def delta_planes(ts: torch.Tensor, vals: torch.Tensor, counts: torch.Tensor,
                 n: int):
    """The delta planes of a tile of whole rows of integer-valued samples,
    made on the card and padded with zero second differences to n columns
    (the engine's tile capacity): int16 timestamp and int8 value second
    differences (the jittered counters' fit), scale 1 -> decode_tiles'
    arguments."""
    S, N = ts.shape
    mant = vals.to(torch.int64)
    planes = []
    for x, d2type in ((ts.to(torch.int64), torch.int16), (mant, torch.int8)):
        d1 = x[:, 1:] - x[:, :-1]
        d2 = d1[:, 1:] - d1[:, :-1]
        if d2.numel() and int(d2.abs().max()) > torch.iinfo(d2type).max:
            raise AssertionError(f"second differences overflow {d2type}")
        plane = torch.zeros((S, n - 2), dtype=d2type, device=ts.device)
        plane[:, :N - 2] = d2
        planes += [x[:, 0].to(torch.int32).contiguous(),
                   d1[:, 0].to(torch.int32).contiguous(), plane]
        del d1, d2
    return (*planes, torch.ones(S, dtype=torch.float64, device=ts.device),
            counts)


# Phase hooks for a checkout whose kernels have none: `macro`_AFTER(k)
# (B12) or a bare `macro` test (B7) ends a row after phase k in a build
# with -D`macro`=k, inserted after anchors where that version's phases end.
# B12 (rollup.cu decode_rollup, the per-plane decode of earlier versions):
_B12_STOP_HOOK = (
    "#ifndef VM_B12_STOP\n#define VM_B12_STOP 0\n#endif\n"
    "#define VM_B12_STOP_AFTER(k) \\\n"
    "  if (VM_B12_STOP == (k)) { \\\n"
    "    if (threadIdx.x == 0) out[row * T] = v[0]; \\\n"
    "    continue; \\\n"
    "  }\n")
_B12_PATCHES = tuple(
    (anchor, f"    VM_B12_STOP_AFTER({k});\n") for k, anchor in enumerate((
        "n, 0, a.scale[row], nullptr, v, warp_sums);\n    __syncthreads();\n",
        "if (threadIdx.x == 0) s_irregular = irregular;\n    }\n"
        "    __syncthreads();\n"), 1))
# B7 (select.cu rank_median of PRs 2-8: a block per row, block_select
# then block_min_above): 1 ends after the staging loop, 2 after the radix
# select (no block_min_above)
_B7_STOP_HOOK = "#ifndef VM_B7_STOP\n#define VM_B7_STOP 0\n#endif\n"
_B7_PATCHES = (
    ("    live += block_count(v == v);\n  }\n",
     "  if (VM_B7_STOP == 1) {\n    if (threadIdx.x == 0) rank[s] = live;\n"
     "    return;\n  }\n"),
    ("  const unsigned long long k0 = block_select(key, T, j0, &less, "
     "&equal);\n",
     "  if (VM_B7_STOP == 2) return key_value(k0);\n"))
#: (source, macro, hook prepended, anchor patches) of each stop build
STOPS = {"b12": ("rollup", "VM_B12_STOP", _B12_STOP_HOOK, _B12_PATCHES),
         "b7": ("select", "VM_B7_STOP", _B7_STOP_HOOK, _B7_PATCHES)}


def stop_libs(kernels, root: str, part: str, stops=(1, 2)) -> dict:
    """Diagnostic builds of the checkout's csrc source of `part` (STOPS),
    each row ending after phase k, loaded with the checkout's signatures:
    {k: library}.  A source without the macro is patched at its anchors.
    Built once per source under this checkout's _build/<part>_stop, all
    stops at once."""
    name, macro, hook, patches = STOPS[part]
    csrc = Path(root).resolve() / "victoriametrics_tpu_torch" / "csrc"
    src = (csrc / f"{name}.cu").read_text()
    if macro not in src:
        for anchor, insert in patches:
            if src.count(anchor) != 1:
                raise RuntimeError(f"{part} stop: anchor not found once")
            src = src.replace(anchor, anchor + insert)
        src = hook + src
    out = Path(REPO) / "victoriametrics_tpu_torch" / "_build" / f"{part}_stop"
    out.mkdir(parents=True, exist_ok=True)
    digest = hashlib.blake2b(src.encode(), digest_size=8).hexdigest()
    cu = out / f"{name}-{digest}.cu"
    cu.write_text(src)
    procs = []
    paths = {k: out / f"lib{name}-stop{k}-{digest}.so" for k in stops}
    for k, so in paths.items():
        if not so.exists():
            procs.append((k, so, subprocess.Popen(
                [kernels.nvcc(), *kernels.NVCC_FLAGS, f"-D{macro}={k}",
                 "-I", str(csrc), "-o", str(so), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    for k, so, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"{part} stop {k} build failed:\n"
                               f"{log.decode(errors='replace')}")
    libs = {}
    for k, so in paths.items():
        h = ctypes.CDLL(str(so))
        for fn, argtypes in kernels.SIGNATURES[name].items():
            getattr(h, fn).argtypes = argtypes
            getattr(h, fn).restype = ctypes.c_int
        h.vm_cuda_error_string.argtypes = [ctypes.c_int]
        h.vm_cuda_error_string.restype = ctypes.c_char_p
        libs[k] = h
    return libs


@contextlib.contextmanager
def _use_lib(kernels, name: str, h):
    """kernels.lib(name) is `h` inside the block."""
    keep = kernels.lib(name)
    kernels._libs[name] = h
    try:
        yield
    finally:
        kernels._libs[name] = keep


def b5_times(tm, dr, kernels, ts, vals, counts, cfg, func: str,
             n: int) -> dict:
    """B5 func over the tile: device_ms, the launch split, the bound, and
    (a port with B5's plan) the plan and the call forced onto the global
    search."""
    S, N = ts.shape
    T = dr.num_steps(cfg)

    def b5():
        return dr.rollup_tile(func, ts, vals, counts, cfg)

    out = {"S": S, "N": N, "T": T, "func": func,
           "device_ms": tm.device_ms(b5, n),
           "split": launch_split(kernels, b5),
           "bound_ms": tm.bound(int(counts.sum()) * 12 + S * 4 + S * T * 8,
                                15 * S * T)["bound_ms"]}
    if hasattr(dr, "b5_plan"):  # a port with B5's staged path and plan
        out["plan"] = dr.b5_plan(
            S, N, T, cfg.step, cfg.lookback,
            dr.scrape_hint(N, T, cfg.step, cfg.lookback),
            kernels.sm_count(ts.device))._asdict()
        out["global_device_ms"] = tm.device_ms(
            lambda: dr.rollup_tile(func, ts, vals, counts, cfg,
                                   force_global=True), n)
    return out


def b12_times(tm, dr, dd, kernels, stops, ts, vals, counts, cfg,
              n: int) -> dict:
    """B12 rate on the tile's delta planes at the engine's tile capacity
    beside K1 alone and K1 then B5 (device_ms), its phases from the
    diagnostic builds, and its bound."""
    from victoriametrics_tpu_torch.query.cuda_engine import tile_capacity
    S, N_rows = ts.shape
    N = tile_capacity(N_rows)
    T = dr.num_steps(cfg)
    planes = delta_planes(ts, vals, counts, N)
    k1 = dd.decode_tiles(*planes, N)
    if not (torch.equal(k1[0][:, :N_rows], ts) and
            torch.equal(k1[1][:, :N_rows], vals)):
        raise AssertionError("delta planes: K1 does not rebuild the tile")
    del k1

    def b12():
        return dd.decode_and_rollup("rate", *planes, cfg, N)

    plane_bytes = sum(t.numel() * t.element_size() for t in planes)
    out = {"S": S, "n": N, "T": T, "device_ms": tm.device_ms(b12, n),
           "k1_device_ms": tm.device_ms(
               lambda: dd.decode_tiles(*planes, N), n),
           "k1_then_b5_device_ms": tm.device_ms(
               lambda: dr.rollup_tile("rate", *dd.decode_tiles(*planes, N),
                                      counts, cfg), n),
           "bound_ms": tm.bound(plane_bytes + S * T * 8,
                                2 * 2 * S * N + 15 * S * T)["bound_ms"]}
    for k, h in stops.items():
        with _use_lib(kernels, "rollup", h):
            out[f"stop{k}_device_ms"] = tm.device_ms(b12, n)
    return out


def k1_times(tm, dd, ts, vals, counts, n: int, chunks=()) -> dict:
    """K1 on the tile's delta planes at the engine's tile capacity, as made
    (int16 timestamp and int8 value planes), with the value plane widened
    to int16 and with both widened to int32: device_ms beside the bound,
    for a port with K1's plan its plan, and the call with its rows forced
    into each of `chunks` on the planes as made."""
    from victoriametrics_tpu_torch.query.cuda_engine import tile_capacity
    S, N_rows = ts.shape
    N = tile_capacity(N_rows)
    planes = list(delta_planes(ts, vals, counts, N))
    got = dd.decode_tiles(*planes, N)
    if not (torch.equal(got[0][:, :N_rows], ts) and
            torch.equal(got[1][:, :N_rows], vals)):
        raise AssertionError("delta planes: K1 does not rebuild the tile")
    del got
    out = {"S": S, "n": N}
    for name, tt, vt in (("int16_int8", None, None),
                         ("int16_int16", None, torch.int16),
                         ("int32_int32", torch.int32, torch.int32)):
        args = list(planes)
        if tt is not None:
            args[2] = args[2].to(tt)
        if vt is not None:
            args[5] = args[5].to(vt)
        nbytes = sum(t.numel() * t.element_size() for t in args)
        row = {"device_ms": tm.device_ms(lambda: dd.decode_tiles(*args, N),
                                         n),
               **tm.bound(nbytes + S * N * 12, 4 * S * N)}
        if hasattr(dd, "k1_plan"):
            row["plan"] = dd.k1_plan(
                N, args[2].element_size(), args[5].element_size(),
                dd.kernels.smem_per_sm(ts.device))._asdict()
        out[name] = row
        del args
    if hasattr(dd, "k1_plan"):
        for chunk in chunks:
            with _k1_chunk(dd, chunk):
                out[f"chunk_{chunk}"] = tm.device_ms(
                    lambda: dd.decode_tiles(*planes, N), n)
    return out


@contextlib.contextmanager
def _k1_chunk(dd, chunk: int):
    """dd.k1_plan picks `chunk` columns inside the block."""
    keep = dd.k1_plan
    dd.k1_plan = lambda n, tb, vb, *_: dd.K1Plan(chunk,
                                                 dd.k1_smem(chunk, tb, vb))
    try:
        yield
    finally:
        dd.k1_plan = keep


_ALONE_SLEEP_CYCLES = 1_000_000
_L2_CLEAN = {}


def alone_ms(fn, setup=None, reps: int = 21) -> float:
    """Median device ms of what fn launches, each call between two CUDA
    events after a device sleep (the host's launch time hidden); `setup`
    runs before each call, outside the span, then a 256 MB read leaves the
    L2 cache clean (setup's own dirty lines written back)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in _L2_CLEAN:
        _L2_CLEAN[dev] = torch.ones(64 << 20, dtype=torch.int32, device=dev)
    times = []
    for i in range(reps + 1):
        if setup is not None:
            setup()
        _L2_CLEAN[dev].sum()
        torch.cuda._sleep(_ALONE_SLEEP_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        if i:  # the first call warms up
            times.append(a.elapsed_time(b))
    return statistics.median(times)


@contextlib.contextmanager
def _lanes(dr, lanes):
    """dr.append_plan picks `lanes` inside the block (None: the plan's)."""
    keep = getattr(dr, "append_plan", None)
    if lanes is not None:
        dr.append_plan = lambda K: lanes
    try:
        yield
    finally:
        if keep is not None:
            dr.append_plan = keep


def append_times(tm, dr, dev, gen, sweep=(4, 8, 16, 32)) -> dict:
    """K3 and B10 in place, each call alone after a device sleep on a tile
    restored before it: K3 at the dashboard's refresh ([8192, 1856], K 8,
    one new scrape a row), B10 at the fleet's steady interval ([8, 8192,
    384], K 8, four live a row) and its 30-minute resume (K 120, all
    live), with their bounds; beside them a one-element PyTorch add, the
    launch floor; for a port with append_plan, each shape also at each of
    `sweep`'s lanes a row."""
    floor_t = torch.zeros(1, device=dev)
    out = {"launch_floor_ms": alone_ms(lambda: floor_t.add_(1))}

    def case(shape, N, K, live, fleet):
        ts = torch.randint(0, 10**6, (*shape, N), generator=gen, device=dev,
                           dtype=torch.int32)
        vals = torch.rand((*shape, N), generator=gen, device=dev,
                          dtype=torch.float64)
        counts = torch.full(shape, N - K - 8, dtype=torch.int32, device=dev)
        new_ts = torch.randint(10**6, 2 * 10**6, (*shape, K), generator=gen,
                               device=dev, dtype=torch.int32)
        new_vals = torch.rand((*shape, K), generator=gen, device=dev,
                              dtype=torch.float64)
        new_counts = torch.full(shape, live, dtype=torch.int32, device=dev)
        bufs = [t.clone() for t in (ts, vals, counts)]
        fn = dr.fleet_append_tile if fleet else dr.append_tile

        def fresh():
            for b, t in zip(bufs, (ts, vals, counts)):
                b.copy_(t)

        def call():
            fn(*bufs, new_ts, new_vals, new_counts)

        rows = counts.numel()
        n_new = rows * live
        row = {"shape": [*shape, N, K], "live": live,
               "lanes": dr.append_plan(K) if hasattr(dr, "append_plan")
               else 32,
               "alone_ms": alone_ms(call, fresh),
               **tm.bound(n_new * 24 + rows * 12, n_new)}
        if hasattr(dr, "append_plan"):
            for lanes in sweep:
                with _lanes(dr, lanes):
                    row[f"lanes_{lanes}_ms"] = alone_ms(call, fresh)
        return row

    out["k3_dashboard"] = case((8192,), 1856, 8, 1, False)
    out["b10_steady"] = case((8, 8192), 384, 8, 4, True)
    out["b10_resume"] = case((8, 8192), 384, 120, 120, True)
    return out


@contextlib.contextmanager
def _timed_items(waits: list):
    """Every Tensor.item() inside the block appends its host seconds to
    `waits`: the wrappers' host syncs."""
    item = torch.Tensor.item

    def timed(self):
        t0 = time.perf_counter()
        try:
            return item(self)
        finally:
            waits.append(time.perf_counter() - t0)

    torch.Tensor.item = timed
    try:
        yield
    finally:
        torch.Tensor.item = item


def sync_waits(fn, reps: int = 5) -> dict:
    """The host syncs of one fn() call: their count and the median over
    `reps` calls of their summed host ms."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        waits = []
        with _timed_items(waits):
            fn()
        torch.cuda.synchronize()
        runs.append(waits)
    return {"calls": len(runs[0]),
            "ms": statistics.median(sum(w) for w in runs) * 1e3}


def b15_times(tm, dr, kernels, meshlib, RollupConfig, ts, vals, valid,
              func: str, n: int) -> dict:
    """B15 func over a tile's columns on the (2, 4) mesh of 8 logical
    shards of the card, halo 32, steps of 60 s: device_ms, ms, host_ms,
    its launch split (each launch alone), its host syncs, the gap between
    its device time and its launches' sum (host gaps between launches),
    its bound, and B5 over the same valid samples (compacted per row) on
    the same grid."""
    S, N = ts.shape
    dev = ts.device
    mesh = meshlib.make_mesh(2, 4, [dev] * 8)
    parts = [meshlib.split_2d(mesh, x) for x in (ts, vals, valid)]
    cfg = RollupConfig(0, N * SCRAPE - 60_000, 60_000, WINDOW)
    T = dr.num_steps(cfg)
    step = meshlib.time_sharded_rollup(mesh, func, cfg, 32)

    def b15():
        return step(*parts)

    order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
    ts5 = torch.where(valid, ts, 2**31 - 1).gather(1, order)
    v5 = torch.where(valid, vals, 0.0).gather(1, order)
    c5 = valid.sum(dim=1).to(torch.int32)
    del order
    out = {"S": S, "N": N, "T": T, "func": func, "mesh": [2, 4],
           "halo": 32, **tm.three_ms(b15, n, reps=5),
           "split": launch_split(kernels, b15),
           "syncs": sync_waits(b15),
           "b5_device_ms": tm.device_ms(
               lambda: dr.rollup_tile(func, ts5, v5, c5, cfg), n),
           "bound_ms": tm.bound(S * N * 13 + S * T * 8, 15 * S * T)[
               "bound_ms"]}
    out["launch_ms"] = sum(v["ms"] for v in out["split"].values())
    out["gap_ms"] = out["device_ms"] - out["launch_ms"]
    return out


def b7_times(tm, dr, kernels, stops, rolled, n: int) -> dict:
    """B7's five kinds over a rolled tile (three ways each, and the
    kernel alone after a device sleep: kernel_ms), avg beside
    torch.nanmean and the median beside torch.nanquantile, the median's
    phases from the diagnostic builds (stop 1: staged; stop 2: selected),
    the bound and, for a port with B7's plan, the plan."""
    S, T = rolled.shape
    out = {"S": S, "T": T,
           "bound_ms": tm.bound(S * T * 8 + S * 8, S * T)["bound_ms"]}
    for kind in dr.RANK_KINDS:
        def fn(kind=kind):
            return dr.rank_rows(rolled, kind)
        out[kind] = {**tm.three_ms(fn, n),
                     "kernel_ms": launch_split(kernels, fn, 10, ("select",))[
                         "vm_rank_rows"]["ms"]}
    out["avg"]["library"] = tm.library_or_oom(
        lambda: torch.nanmean(rolled, dim=1), n)
    out["median"]["library"] = tm.library_or_oom(
        lambda: torch.nanquantile(rolled, 0.5, dim=1), 3)
    for k, h in stops.items():
        with _use_lib(kernels, "select", h):
            out["median"][f"stop{k}_device_ms"] = tm.device_ms(
                lambda: dr.rank_rows(rolled, "median"), n)
    if hasattr(dr, "rank_plan"):  # a port with B7's plan
        out["plan"] = dr.rank_plan(S, T, kernels.sm_count(
            rolled.device))._asdict()
    return out



def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO,
                    help="checkout to import the port from")
    ap.add_argument("--parts", default=",".join(PARTS),
                    help="comma-separated subset of " + ",".join(PARTS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    parts = set(args.parts.split(","))
    if not parts <= set(PARTS):
        ap.error(f"--parts: unknown {sorted(parts - set(PARTS))}")
    if not torch.cuda.is_available():
        print("select_timing: no CUDA device", file=sys.stderr)
        return 2
    tm = load_timing()
    sys.path.insert(0, os.path.abspath(args.root))
    from victoriametrics_tpu_torch import kernels
    from victoriametrics_tpu_torch.ops import device_decode as dd
    from victoriametrics_tpu_torch.ops import device_rollup as dr
    from victoriametrics_tpu_torch.ops.rollup_np import RollupConfig
    from victoriametrics_tpu_torch.parallel import mesh as meshlib
    from victoriametrics_tpu_torch.parallel.partition import split_rows
    dev = torch.device("cuda", 0)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    tiles = bool(parts - {"b9", "b10"})  # parts on the rolled tiles
    kernels.build(("decode", "rollup", "select", "quantile", "mesh", "tile")
                  if tiles or "b9" in parts else ("tile",))
    stop = {p: stop_libs(kernels, args.root, p) if p in parts else {}
            for p in STOPS}
    res = {"label": args.label, "root": args.root, "gpu": gpu,
           "parts": sorted(parts), "build_s": time.perf_counter() - t0}
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    # the dashboard's grid (chip_smoke.dashboard_grid): 6 h at 15 s
    n = 1440
    end = T_START + -(-((n - 1) * SCRAPE + JITTER) // 60_000) * 60_000
    start = end - ((n - 1) * SCRAPE - WINDOW)
    dash = {}

    def at_dashboard(ts, vals, counts, cfg):
        if "b5" in parts:
            dash["b5_rate"] = b5_times(tm, dr, kernels, ts, vals, counts,
                                       cfg, "rate", 50)
            dash["b5_tlast"] = b5_times(
                tm, dr, kernels, ts, vals, counts,
                RollupConfig(start, end, 60_000, WINDOW), "tlast_over_time",
                50)
        if "b12" in parts:
            dash["b12"] = b12_times(tm, dr, dd, kernels, stop["b12"], ts, vals,
                                    counts, cfg, 20)
        if "k1" in parts:
            dash["k1"] = k1_times(tm, dd, ts, vals, counts, 20,
                                  chunks=(1856, 928))
        if "k2" in parts:
            dash["k2"] = {
                "by_instance": k2_times(
                    tm, dr, kernels, meshlib, split_rows, ts, vals, counts,
                    cfg, "rate", "sum", 256, 20),
                "one_group": k2_times(
                    tm, dr, kernels, meshlib, split_rows, ts, vals, counts,
                    cfg, "rate", "sum", 1, 20)}

    if tiles:
        rolled = rate_tile(dr, RollupConfig, dev, gen, 8192, n, start, end,
                           60_000, at_dashboard)
        if "b15" in parts:  # 1440 columns from 0, gaps in every seventh row
            ts, vals, _ = counter_tile(dev, gen, (8192,), n, 0)
            valid = torch.ones_like(ts, dtype=torch.bool)
            valid[::7, 100:103] = False
            dash["b15"] = {func: b15_times(tm, dr, kernels, meshlib,
                                           RollupConfig, ts, vals, valid, func,
                                           50)
                           for func in ("rate", "timestamp")}
            del ts, vals, valid
        res["dashboard"] = dash
        if "topk" in parts:
            dash.update(shape_times(tm, dr, rolled, (10, 20, 8192), 50))
        if "quantile" in parts:
            dash["quantile_m32"] = quantile_times(tm, dr, rolled, 256, 0.9, 50)
            dash["quantile_m8192"] = quantile_times(tm, dr, rolled, 1, 0.5, 20)
        if "b7" in parts:
            dash["b7"] = b7_times(tm, dr, kernels, stop["b7"], rolled, 50)
        sweep = hasattr(dr, "topk_plan")  # a port with B6's scan-path plan
        if sweep and "topk" in parts:
            dash["clusters"] = cluster_sweep(tm, dr, kernels, rolled, (10, 20),
                                             (1, 2, 4, 8, 16))
        del rolled
        n = 5760
        full = {}

        def at_full_width(ts, vals, counts, cfg):
            if "b5" in parts:
                for func in ("rate", "deriv"):
                    full[f"b5_{func}"] = b5_times(
                        tm, dr, kernels, ts, vals, counts,
                        dr.normalized_cfg(func, cfg), func, 5)
            if "b12" in parts:
                full["b12"] = b12_times(tm, dr, dd, kernels, stop["b12"], ts,
                                        vals, counts, cfg, 5)
                torch.cuda.empty_cache()
            if "k1" in parts:
                full["k1"] = k1_times(tm, dd, ts, vals, counts, 5,
                                      chunks=(7232, 3616))
                torch.cuda.empty_cache()
            if "b15" in parts:  # every sample valid; from 0 (start = T_START)
                valid = torch.ones_like(ts, dtype=torch.bool)
                full["b15"] = {func: b15_times(tm, dr, kernels, meshlib,
                                               RollupConfig, ts, vals, valid,
                                               func, 5)
                               for func in ("rate", "timestamp")}
                del valid
                torch.cuda.empty_cache()
            if "k2" in parts:
                full["k2"] = {f"{aggr}_{func}": k2_times(
                    tm, dr, kernels, meshlib, split_rows, ts, vals, counts,
                    cfg, func, aggr, 3125, 5)
                    for func, aggr in (("rate", "sum"), ("deriv", "avg"))}

        rolled = rate_tile(dr, RollupConfig, dev, gen, 100_000, n, T_START,
                           T_START + n * SCRAPE, SCRAPE, at_full_width)
        torch.cuda.empty_cache()
        res["full_width"] = full
        if "topk" in parts:
            full.update(shape_times(tm, dr, rolled, (10, 20), 10))
            if sweep:
                full["clusters"] = cluster_sweep(tm, dr, kernels, rolled,
                                                 (10, 20), (1, 2, 4, 8))
        if "b7" in parts:
            full["b7"] = b7_times(tm, dr, kernels, stop["b7"], rolled, 5)
        if "quantile" in parts:
            full["quantile_instant"] = quantile_times(
                tm, dr, rolled[:, -1:].contiguous(), 1, 0.99, 50)
        del rolled
        torch.cuda.empty_cache()
    if "b9" in parts:
        res["fleet"] = fleet_times(tm, dr, RollupConfig, dev, gen, 10)
    if "b10" in parts:
        res["append"] = append_times(tm, dr, dev, gen)
    res["seconds"] = time.perf_counter() - t0
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
