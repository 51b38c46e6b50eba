"""Flight-recorder overhead smoke check (tools/lint.sh gate).

The flightrec contract is "a few hundred ns per event, invisible at
serving granularity": the record path is one flag check, one TLS
lookup, five slot stores and a cursor bump — no allocation, no lock.
This microbench enforces that contract two ways:

1. **Per-event budget**: the absolute cost of one ``rec()`` call with
   the recorder ON must stay under ``VM_FLIGHT_SMOKE_NS`` (default
   5000 ns — an order of magnitude of slack over the measured ~500 ns,
   so only a real regression, e.g. an allocation or a lock sneaking
   onto the record path, trips it).

2. **Workload delta**: a simulated serving operation shaped like a real
   refresh (~1 ms of numpy work bracketed by a realistic number of
   phase spans) is timed with the recorder ON vs ``VM_FLIGHTREC=0``;
   the delta must stay under ``VM_FLIGHT_SMOKE_PCT`` (default 2%).
   Trials are interleaved on/off and each side keeps its MINIMUM (the
   noise-robust statistic for timing), with a few full retries before
   declaring failure — CI boxes are noisy, regressions are not.

Run directly: ``python -m victoriametrics_tpu_torch.devtools.flight_overhead``
(prints one JSON line; exit 0 = within budget, 1 = overhead regression).

The port's copy of ``victoriametrics_tpu/devtools/flight_overhead.py``,
whole.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from ..utils import flightrec


def _per_event_ns(n: int = 50_000) -> float:
    """Amortized cost of one rec() call, recorder ON."""
    rec = flightrec.rec
    t = time.perf_counter()
    t0 = time.perf_counter()
    for _ in range(n):
        rec("smoke:event", t, 1e-6)
    return (time.perf_counter() - t0) / n * 1e9


def _workload(arr: np.ndarray, spans: int) -> None:
    """One simulated instrumented refresh: numpy work dominated, with
    `spans` flight events around it (the real serving path records
    ~10-20 spans per ~100ms refresh; this compresses the same ratio
    into a ~1ms op so the smoke finishes in seconds)."""
    rec = flightrec.rec
    t0 = time.perf_counter()
    for k in range(spans):
        # the "work": what a phase actually does between laps
        arr[k % 8] = np.sqrt(arr[(k + 1) % 8]).sum()
        now = time.perf_counter()
        rec("smoke:phase", t0, now - t0)
        t0 = now


def _time_workload(reps: int, spans: int, arr: np.ndarray) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        _workload(arr, spans)
        best = min(best, time.perf_counter() - t0)
    return best


def run_smoke(max_event_ns: float, max_delta_pct: float,
              retries: int = 3) -> dict:
    """Returns the result dict; ``result["ok"]`` is the verdict."""
    arr = np.random.default_rng(7).random((8, 65_536))
    spans = 16
    reps = 30
    prev_env = os.environ.get("VM_FLIGHTREC")
    try:
        event_ns = delta_pct = float("inf")
        for _attempt in range(retries):
            os.environ.pop("VM_FLIGHTREC", None)
            flightrec.reconfigure()
            _time_workload(5, spans, arr)           # warm-up both paths
            # best across attempts: noise only inflates a measurement,
            # so the minimum is the honest estimate and a real
            # regression raises every attempt's floor
            event_ns = min(event_ns, _per_event_ns())
            # interleave on/off so clock drift hits both sides equally
            t_on = t_off = float("inf")
            for _ in range(4):
                os.environ.pop("VM_FLIGHTREC", None)
                flightrec.reconfigure()
                t_on = min(t_on, _time_workload(reps, spans, arr))
                os.environ["VM_FLIGHTREC"] = "0"
                flightrec.reconfigure()
                t_off = min(t_off, _time_workload(reps, spans, arr))
            delta_pct = min(delta_pct, (t_on - t_off) / t_off * 1e2)
            if event_ns <= max_event_ns and delta_pct <= max_delta_pct:
                break
    finally:
        if prev_env is None:
            os.environ.pop("VM_FLIGHTREC", None)
        else:
            os.environ["VM_FLIGHTREC"] = prev_env
        flightrec.reconfigure()
    return {
        "per_event_ns": round(event_ns, 1),
        "max_event_ns": max_event_ns,
        "workload_delta_pct": round(delta_pct, 3),
        "max_delta_pct": max_delta_pct,
        "ok": event_ns <= max_event_ns and delta_pct <= max_delta_pct,
    }


def main() -> int:
    try:
        max_event_ns = float(os.environ.get("VM_FLIGHT_SMOKE_NS", "5000"))
    except ValueError:
        max_event_ns = 5000.0
    try:
        max_delta_pct = float(os.environ.get("VM_FLIGHT_SMOKE_PCT", "2"))
    except ValueError:
        max_delta_pct = 2.0
    res = run_smoke(max_event_ns, max_delta_pct)
    res["check"] = "flightrec_overhead"
    print(json.dumps(res))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
