#!/usr/bin/env python3
"""Time B6 topk_select and take_rows, and the PyTorch calls that compute
the same functions, on one CUDA card, three ways each.

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
picks held against the plan's, beside the plan's choice.
``--root`` imports the port from another checkout (a parent commit
unpacked under a gitignored directory), so two versions compare in one
chip call: parent, change, change, parent.  Prints one JSON line with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
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


def rate_tile(dr, RollupConfig, dev, gen, S: int, N: int, start: int,
              end: int, step: int) -> torch.Tensor:
    """rate(m[5m]) of S jittered counters of N samples from T_START."""
    jit = torch.randint(-JITTER, JITTER + 1, (S, N), generator=gen,
                        device=dev, dtype=torch.int32)
    ts = (torch.arange(N, device=dev, dtype=torch.int32) * SCRAPE)[None] + \
        jit + int(T_START - start)
    del jit
    vals = torch.randint(0, 50, (S, N), generator=gen, device=dev,
                         dtype=torch.int64).cumsum_(1).to(torch.float64)
    counts = torch.full((S,), N, dtype=torch.int32, device=dev)
    cfg = dr.normalized_cfg("rate", RollupConfig(start, end, step, WINDOW))
    return dr.rollup_tile("rate", ts, vals, counts, cfg)


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
    dev = torch.device("cuda", 0)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    kernels.build(("rollup", "select"))
    res = {"label": args.label, "root": args.root, "gpu": gpu,
           "build_s": time.perf_counter() - t0}
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    # the dashboard's grid (chip_smoke.dashboard_grid): 6 h at 15 s
    n = 1440
    end = T_START + -(-((n - 1) * SCRAPE + JITTER) // 60_000) * 60_000
    rolled = rate_tile(dr, RollupConfig, dev, gen, 8192, n,
                       end - ((n - 1) * SCRAPE - WINDOW), end, 60_000)
    res["dashboard"] = shape_times(tm, dr, rolled, (10, 20, 8192), 50)
    sweep = hasattr(dr, "topk_plan")  # the scan path's plan (PR 5 on)
    if sweep:
        res["dashboard"]["clusters"] = cluster_sweep(
            tm, dr, kernels, rolled, (10, 20), (1, 2, 4, 8, 16))
    del rolled
    n = 5760
    rolled = rate_tile(dr, RollupConfig, dev, gen, 100_000, n, T_START,
                       T_START + n * SCRAPE, SCRAPE)
    torch.cuda.empty_cache()
    res["full_width"] = shape_times(tm, dr, rolled, (10, 20), 10)
    if sweep:
        res["full_width"]["clusters"] = cluster_sweep(
            tm, dr, kernels, rolled, (10, 20), (1, 2, 4, 8))
    res["seconds"] = time.perf_counter() - t0
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
