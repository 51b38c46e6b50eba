#!/usr/bin/env python3
"""Time the cold upload of one checkout on one CUDA card, with the peak
host memory it takes.

    python3 tools/cold_upload.py [--root DIR] [--seed N] [--label L]

Runs ``cuda_engine._upload_tiles`` (the host float->decimal and delta
planes, the H2D copy and K1) of the checkout at DIR (default: this one)
on chip_smoke.py's counters at the dashboard's shape (8192 series x 1440
samples) and the full width's (100,000 x 5760), one cold upload each.
For each it prints one JSON line: the upload's wall ms (to a
synchronise), the process's resident set before, at its peak during and
after the upload (VmRSS read from /proc/self/status every 10 ms by a
thread), and the tile's shape.  Only the decode library is built (and
the native host codec, where the checkout has one).
Parent and change compare in one chip call, each in a process of its
own:

    for r in P . . P; do python3 tools/cold_upload.py --root $r; done
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import threading
import time

SHAPES = {"dashboard": (8192, 1440), "full_width": (100_000, 5760)}


def rss_bytes() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


class PeakRss:
    """The largest VmRSS sampled while the block runs."""

    def __init__(self, interval: float = 0.01):
        self.interval, self.peak = interval, 0
        self._done = threading.Event()

    def _run(self):
        while not self._done.wait(self.interval):
            self.peak = max(self.peak, rss_bytes())

    def __enter__(self):
        self.peak = rss_bytes()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._done.set()
        self._thread.join()
        self.peak = max(self.peak, rss_bytes())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout whose port runs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--label", default=None)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from victoriametrics_tpu_torch import kernels
    from victoriametrics_tpu_torch.ops.rollup_np import RollupConfig
    from victoriametrics_tpu_torch.query import cuda_engine as ce
    from victoriametrics_tpu_torch.storage.storage import SeriesData

    if not torch.cuda.is_available():
        print("cold_upload: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    kernels.lib("decode")
    try:  # the host codec, where the checkout has one: built before timing
        from victoriametrics_tpu_torch import native
        native.build()
    except ImportError:
        pass
    label = args.label or root
    print(json.dumps({"root": label, "gpu": gpu,
                      "build_s": time.perf_counter() - t0}), flush=True)
    rng = np.random.default_rng(args.seed)
    for shape, (S, N) in SHAPES.items():
        ts, vals = cs.counters(rng, S, N, cs.T_START)
        series = [SeriesData(None, ts[i], vals[i], raw_name=b"c%d" % i)
                  for i in range(S)]
        cfg = RollupConfig(cs.T_START, cs.T_START + N * cs.SCRAPE,
                           cs.SCRAPE, cs.WINDOW)
        engine = ce.CUDAEngine(device=dev, cache_bytes=64 << 30)
        gc.collect()
        with PeakRss() as rss:
            before = rss.peak
            t0 = time.perf_counter()
            tiles = ce._upload_tiles(engine, series, cfg)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
        after = rss_bytes()
        print(json.dumps({
            "root": label, "shape": shape, "series": S, "samples": S * N,
            "upload_ms": wall * 1e3, "rss_before_bytes": before,
            "rss_peak_bytes": rss.peak, "rss_after_bytes": after,
            "peak_over_before_bytes": rss.peak - before,
            "tile": list(tiles[0].shape)}), flush=True)
        del tiles, series, ts, vals, engine
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
