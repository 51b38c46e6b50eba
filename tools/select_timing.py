#!/usr/bin/env python3
"""Time B6 topk_select and take_rows, B8 quantile_groups and B9
fleet_rollup_aggregate_tile, and the PyTorch calls that compute the same
functions where there is one, on one CUDA card, three ways each.

    python3 tools/select_timing.py [--root DIR] [--seed N] [--label L]

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
``--root`` imports the port from another checkout (a parent commit
unpacked under a gitignored directory), so two versions compare in one
chip call: parent, change, change, parent.  Prints one JSON line with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import torch

T_START, SCRAPE, JITTER, WINDOW = 1_753_700_000_000, 15_000, 2_000, 300_000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def launch_split(kernels, fn, reps: int = 5) -> dict:
    """fn's launches of the rollup and mesh libraries, each timed alone:
    per C entry point, its launches per call and the median over `reps`
    calls of their summed ms.  The wrapper's own host syncs run as
    always."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        spans = []
        with _timed_libs(kernels, ("rollup", "mesh"), spans):
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO,
                    help="checkout to import the port from")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("select_timing: no CUDA device", file=sys.stderr)
        return 2
    tm = load_timing()
    sys.path.insert(0, os.path.abspath(args.root))
    from victoriametrics_tpu_torch import kernels
    from victoriametrics_tpu_torch.ops import device_rollup as dr
    from victoriametrics_tpu_torch.ops.rollup_np import RollupConfig
    from victoriametrics_tpu_torch.parallel import mesh as meshlib
    from victoriametrics_tpu_torch.parallel.partition import split_rows
    dev = torch.device("cuda", 0)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    kernels.build(("rollup", "select", "quantile", "mesh"))
    res = {"label": args.label, "root": args.root, "gpu": gpu,
           "build_s": time.perf_counter() - t0}
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    # the dashboard's grid (chip_smoke.dashboard_grid): 6 h at 15 s
    n = 1440
    end = T_START + -(-((n - 1) * SCRAPE + JITTER) // 60_000) * 60_000
    k2 = {}

    def k2_dashboard(ts, vals, counts, cfg):
        k2.update(by_instance=k2_times(
            tm, dr, kernels, meshlib, split_rows, ts, vals, counts, cfg,
            "rate", "sum", 256, 20),
            one_group=k2_times(tm, dr, kernels, meshlib, split_rows, ts,
                               vals, counts, cfg, "rate", "sum", 1, 20))

    rolled = rate_tile(dr, RollupConfig, dev, gen, 8192, n,
                       end - ((n - 1) * SCRAPE - WINDOW), end, 60_000,
                       k2_dashboard)
    res["dashboard"] = shape_times(tm, dr, rolled, (10, 20, 8192), 50)
    res["dashboard"]["k2"] = k2
    res["dashboard"]["quantile_m32"] = quantile_times(tm, dr, rolled, 256,
                                                      0.9, 50)
    res["dashboard"]["quantile_m8192"] = quantile_times(tm, dr, rolled, 1,
                                                        0.5, 20)
    sweep = hasattr(dr, "topk_plan")  # the scan path's plan (PR 5 on)
    if sweep:
        res["dashboard"]["clusters"] = cluster_sweep(
            tm, dr, kernels, rolled, (10, 20), (1, 2, 4, 8, 16))
    del rolled
    n = 5760
    k2 = {}

    def k2_full(ts, vals, counts, cfg):
        for func, aggr in (("rate", "sum"), ("deriv", "avg")):
            k2[f"{aggr}_{func}"] = k2_times(
                tm, dr, kernels, meshlib, split_rows, ts, vals, counts, cfg,
                func, aggr, 3125, 5)

    rolled = rate_tile(dr, RollupConfig, dev, gen, 100_000, n, T_START,
                       T_START + n * SCRAPE, SCRAPE, k2_full)
    torch.cuda.empty_cache()
    res["full_width"] = shape_times(tm, dr, rolled, (10, 20), 10)
    res["full_width"]["k2"] = k2
    if sweep:
        res["full_width"]["clusters"] = cluster_sweep(
            tm, dr, kernels, rolled, (10, 20), (1, 2, 4, 8))
    res["full_width"]["quantile_instant"] = quantile_times(
        tm, dr, rolled[:, -1:].contiguous(), 1, 0.99, 50)
    del rolled
    torch.cuda.empty_cache()
    res["fleet"] = fleet_times(tm, dr, RollupConfig, dev, gen, 10)
    res["seconds"] = time.perf_counter() - t0
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
