"""Continuous-profiler overhead smoke check (tools/lint.sh gate; the
profiler sibling of flight_overhead.py).

The profiler contract is "default-on and invisible": one
``sys._current_frames()`` walk per thread per 1/VM_PROFILE_HZ seconds
(default 10 Hz) must not dent serving throughput.  The smoke times a
serving-shaped workload (numpy-dominated ops bracketed by cost-
accounting laps, the same seams the real refresh path runs) with the
sampling thread RUNNING vs STOPPED; the delta must stay under
``VM_PROFILE_SMOKE_PCT`` (default 2%).  Trials are interleaved on/off
and each side keeps its MINIMUM across retries — noise inflates
measurements, regressions raise the floor.

Run directly: ``python -m victoriametrics_tpu_torch.devtools.profile_overhead``
(prints one JSON line; exit 0 = within budget, 1 = overhead
regression).  ``VMT_NO_PROFILE_SMOKE=1`` skips it in tools/lint.sh.

The port's copy of ``victoriametrics_tpu/devtools/profile_overhead.py``,
whole.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from ..utils import costacc, profiler


def _workload(arr: np.ndarray, laps: int) -> None:
    """One simulated refresh: numpy work + the cost-accounting laps the
    real serving path records (a tracker is installed, so the laps take
    their real, non-short-circuited path)."""
    t0 = time.perf_counter()
    for k in range(laps):
        arr[k % 8] = np.sqrt(arr[(k + 1) % 8]).sum()
        now = time.perf_counter()
        costacc.lap("smoke:phase", now - t0)
        t0 = now


def _time_workload(reps: int, laps: int, arr: np.ndarray) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        _workload(arr, laps)
        best = min(best, time.perf_counter() - t0)
    return best


def run_smoke(max_delta_pct: float, retries: int = 3) -> dict:
    """Returns the result dict; ``result["ok"]`` is the verdict."""
    arr = np.random.default_rng(11).random((8, 65_536))
    laps = 16
    reps = 30
    hz = profiler.configured_hz() or 10.0
    prev_cost = costacc.set_current(costacc.CostTracker())
    try:
        delta_pct = float("inf")
        for _attempt in range(retries):
            _time_workload(5, laps, arr)  # warm-up
            t_on = t_off = float("inf")
            for _ in range(4):
                # interleave so clock drift hits both sides equally
                if not profiler.PROFILER.ensure_started():
                    # hz forced to 0 in the environment: nothing to
                    # measure, the no-thread no-op IS the contract
                    return {"skipped": "VM_PROFILE_HZ=0", "ok": True}
                t_on = min(t_on, _time_workload(reps, laps, arr))
                profiler.PROFILER.stop()
                t_off = min(t_off, _time_workload(reps, laps, arr))
            delta_pct = min(delta_pct, (t_on - t_off) / t_off * 1e2)
            if delta_pct <= max_delta_pct:
                break
    finally:
        profiler.PROFILER.stop()
        costacc.set_current(prev_cost)
    return {
        "hz": hz,
        "workload_delta_pct": round(delta_pct, 3),
        "max_delta_pct": max_delta_pct,
        "ok": delta_pct <= max_delta_pct,
    }


def main() -> int:
    try:
        max_delta_pct = float(os.environ.get("VM_PROFILE_SMOKE_PCT", "2"))
    except ValueError:
        max_delta_pct = 2.0
    res = run_smoke(max_delta_pct)
    res["check"] = "profiler_overhead"
    print(json.dumps(res))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
