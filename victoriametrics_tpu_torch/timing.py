"""CUDA-event timing and least-time bounds for the port's kernels on one
H100, shared by chip_smoke.py and tools/select_timing.py.

Imports torch and numpy only, so a script can load this file from its own
checkout while it imports the port from another one.
"""

from __future__ import annotations

import time

import numpy as np
import torch

# H100 SXM (NVIDIA data sheet): HBM3 rate, and the FP64 vector peak, used
# for every scalar operation these kernels do (int32 adds and compares,
# float64 arithmetic)
MEM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 34e12


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


def device_ms(fn, n: int = 50) -> float:
    """Device time of one call: CUDA events around n back-to-back calls,
    over n (median of 3 runs, after a warm-up).  Unlike cuda_ms, the card
    does not wait for the host between calls unless the host is slower."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        runs.append(a.elapsed_time(b) / n)
    return float(np.median(runs))


def host_ms(fn, n: int = 50) -> float:
    """Host time of one call with no synchronise: n calls after a
    synchronise, over n."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e3


def three_ms(fn, n: int = 50, reps: int = 10) -> dict:
    """cuda_ms (one call between events, the wrapper's host time included
    where the card waits for it), device_ms and host_ms of fn."""
    return {"ms": cuda_ms(fn, reps), "device_ms": device_ms(fn, n),
            "host_ms": host_ms(fn, n)}


def library_or_oom(fn, n: int) -> dict | str:
    """three_ms of a library call, or a note when it does not fit the
    card's memory."""
    try:
        return three_ms(fn, n, reps=3)
    except torch.cuda.OutOfMemoryError as e:
        torch.cuda.empty_cache()
        return f"out of memory: {str(e).splitlines()[0]}"


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the scalar rate."""
    b, o = nbytes / MEM_BYTES_PER_S, ops / SCALAR_OPS_PER_S
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(b, o) * 1e3,
            "bound_by": "bytes" if b >= o else "operations"}


def topk_bound(S: int, T: int, k: int) -> dict:
    """B6 on [S, T] float64: every value read once and compared once,
    [T, k] int32 picks and bool NaN flags written."""
    return bound(S * T * 8 + T * k * 5, S * T)


def take_rows_bound(M: int, T: int) -> dict:
    """take_rows of M rows of T float64: each row read and written once,
    M int64 indices read."""
    return bound(M * T * 16 + M * 8, 0)


def quantile_bound(S: int, T: int, G: int) -> dict:
    """B8 over a rolled [S, T] float64 tile in G groups: every value read
    and compared once, the int32 order and starts read, [G, T] written."""
    return bound(S * T * 8 + S * 4 + (G + 1) * 4 + G * T * 8, S * T)


def k2_bound(live: int, S: int, G: int, T: int) -> dict:
    """K2 (and B13, whose moments and combine move less than the tile) on
    an [S, N] tile in G groups: each live sample read once (12 B), each
    row's count, group id and order read, the [G, T] output written; 15
    scalar operations per (row, step)."""
    return bound(live * 12 + S * 12 + G * T * 8, 15 * S * T)


def fleet_bound(live: int, B: int, S: int, G: int, T: int) -> dict:
    """B9 on a [B, S, N] bucket: each live sample read once (12 B), the
    per-row counts, order, group ids and v0 and the per-stream arrays, the
    [B, G, T] output; 15 scalar operations per (row, step), as K2."""
    return bound(live * 12 + B * S * (4 + 4 + 4 + 8) + B * (G + 1) * 4 +
                 B * 12 + B * G * T * 8, 15 * B * S * T)
