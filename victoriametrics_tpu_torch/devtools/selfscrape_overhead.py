"""Self-monitoring plane overhead smoke check (tools/lint.sh gate).

The self-scrape + SLO plane contract is "<2% overhead": the plane is a
single background thread that wakes once per ``-selfScrapeInterval``
(15s default), snapshots the registry, ingests the rows locally and
runs one SLO eval round.  Its steady-state cost is therefore a duty
cycle — ``(scrape_cost + eval_cost) / interval`` — and that is what
this smoke measures and gates, against a REAL Storage and a REAL
SLOEngine (not mocks), with several warm rounds of scraped history in
place so the burn-rate queries touch actual series.

Duty cycle is the noise-robust form of an on/off workload delta for a
background plane: an on/off A-B of a foreground workload mostly dodges
the 15s ticks entirely (the minimum statistic sees zero ticks), while
the duty cycle is exactly the fraction of one core the plane consumes.
Each cost is the MINIMUM over several cycles (noise only inflates a
timing; a real regression raises every cycle's floor), with full
retries before declaring failure.

Gates:

1. **Duty cycle**: ``(min scrape + min eval) / 15s`` must stay under
   ``VM_SELFSCRAPE_SMOKE_PCT`` (default 2).
2. **Per-cycle budget**: one scrape+eval cycle must finish inside
   ``VM_SELFSCRAPE_SMOKE_MS`` (default 300 ms — a cycle that slow
   would also skew the sub-second intervals tests use).

``VMT_NO_SELFSCRAPE_SMOKE=1`` skips (exit 0) for boxes where even the
tiny tmpdir Storage is unwanted.

Run directly:
``python -m victoriametrics_tpu_torch.devtools.selfscrape_overhead``
(prints one JSON line; exit 0 = within budget, 1 = regression).

The port's copy of
``victoriametrics_tpu/devtools/selfscrape_overhead.py``, whole.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time


def _min_cost_s(fn, cycles: int) -> float:
    best = float("inf")
    for _ in range(cycles):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def run_smoke(max_duty_pct: float, max_cycle_ms: float,
              retries: int = 3) -> dict:
    from ..httpapi.prometheus_api import PrometheusAPI
    from ..storage.storage import Storage
    from ..utils import selfscrape

    interval_s = selfscrape.DEFAULT_INTERVAL_S
    tmp = tempfile.mkdtemp(prefix="vmt-selfscrape-smoke-")
    try:
        s = Storage(tmp)
        try:
            api = PrometheusAPI(s)
            engine = api.init_sloplane()
            scraper = selfscrape.SelfScraper(
                s.add_rows, instance="smoke", interval_s=interval_s,
                extra=api.app_metrics)
            # warm history: a few spaced samples so increase()/rate()
            # burn queries see real series, not an empty index
            from ..utils import fasttime
            now_ms = fasttime.unix_ms()
            for k in range(3):
                scraper.scrape_once(ts_ms=now_ms - (3 - k) * 15_000)
            engine.maybe_eval(force=True)

            scrape_s = eval_s = float("inf")
            duty_pct = cycle_ms = float("inf")
            for _attempt in range(retries):
                # interleave the two sides so clock drift hits both
                for _ in range(4):
                    scrape_s = min(scrape_s,
                                   _min_cost_s(scraper.scrape_once, 2))
                    eval_s = min(eval_s, _min_cost_s(
                        lambda: engine.maybe_eval(force=True), 2))
                duty_pct = (scrape_s + eval_s) / interval_s * 1e2
                cycle_ms = (scrape_s + eval_s) * 1e3
                if duty_pct <= max_duty_pct and cycle_ms <= max_cycle_ms:
                    break
            return {
                "scrape_ms": round(scrape_s * 1e3, 3),
                "eval_ms": round(eval_s * 1e3, 3),
                "cycle_ms": round(cycle_ms, 3),
                "max_cycle_ms": max_cycle_ms,
                "interval_s": interval_s,
                "duty_pct": round(duty_pct, 4),
                "max_duty_pct": max_duty_pct,
                "slo_exprs_per_round": engine.exprs_last_round,
                "ok": duty_pct <= max_duty_pct and cycle_ms <= max_cycle_ms,
            }
        finally:
            s.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    if os.environ.get("VMT_NO_SELFSCRAPE_SMOKE") == "1":
        print(json.dumps({"check": "selfscrape_overhead",
                          "skipped": True, "ok": True}))
        return 0
    try:
        max_duty_pct = float(
            os.environ.get("VM_SELFSCRAPE_SMOKE_PCT", "2"))
    except ValueError:
        max_duty_pct = 2.0
    try:
        max_cycle_ms = float(
            os.environ.get("VM_SELFSCRAPE_SMOKE_MS", "300"))
    except ValueError:
        max_cycle_ms = 300.0
    res = run_smoke(max_duty_pct, max_cycle_ms)
    res["check"] = "selfscrape_overhead"
    print(json.dumps(res))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
