"""Materialized-stream fan-out smoke check (tools/lint.sh gate; the
matstream sibling of flight_overhead.py / profile_overhead.py).

The matstream contract is "subscribers are nearly free": one interval
with N subscribers of one expression must cost exactly ONE evaluation
(samples scanned identical to the 1-subscriber interval — the
O(distinct expressions) invariant) and the per-subscriber frame fan-out
must stay a small fraction of the evaluation itself.  The smoke builds
a tiny real store, advances one stream with 1 then with
``VM_MATSTREAM_SMOKE_SUBS`` (default 16) subscribers, and asserts:

- evals per interval == 1 in both runs (counter, not timing);
- samples scanned per interval identical (the flat-scan guard);
- fan-out wall overhead per extra subscriber under
  ``VM_MATSTREAM_SMOKE_MS`` (default 5 ms — generous: frames are built
  once and shared, so the per-subscriber cost is one bounded-queue
  put).

Run directly: ``python -m victoriametrics_tpu_torch.devtools.
matstream_overhead`` (prints one JSON line; exit 0 = within budget,
1 = regression).  ``VMT_NO_MATSTREAM_SMOKE=1`` skips it in
tools/lint.sh.

The port's copy of
``victoriametrics_tpu/devtools/matstream_overhead.py``, whole.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

STEP = 60_000
SCRAPE = 15_000
NS = 16
NN = 120
Q = "sum by (g)(rate(smoke_m[2m]))"


def _seed(s, t0: int):
    rng = np.random.default_rng(1)
    rows = []
    for i in range(NS):
        vals = np.cumsum(rng.integers(0, 30, NN)).astype(np.float64)
        rows.extend((({"__name__": "smoke_m", "i": str(i),
                       "g": f"g{i % 2}"}, t0 + j * SCRAPE, float(vals[j]))
                     for j in range(NN)))
    s.add_rows(rows)
    s.force_flush()


def _run(api, s, end: int, n_subs: int, intervals: int):
    """Advance `intervals` with `n_subs` subscribers; returns (end,
    evals, samples/interval, wall seconds)."""
    subs = [api.matstreams.subscribe(Q, STEP, 20 * STEP)
            for _ in range(n_subs)]
    for sb in subs:  # drain the cold snapshots
        sb.next_frame(timeout_s=2.0, now_ms=end)
    stream = subs[0].stream
    evals0 = stream.evals
    t0 = time.perf_counter()
    samples = []
    for r in range(intervals):
        end += STEP
        s.add_rows([
            ({"__name__": "smoke_m", "i": str(i), "g": f"g{i % 2}"},
             end - STEP + (k + 1) * SCRAPE, float(100 + r + k))
            for i in range(NS) for k in range(4)])
        assert stream.maybe_advance(end)
        samples.append(stream.last_samples_scanned)
        for sb in subs:  # every subscriber drains its copy of the frame
            f = sb.next_frame(timeout_s=2.0, now_ms=end)
            assert f is not None
    dt = time.perf_counter() - t0
    evals = stream.evals - evals0
    for sb in subs:
        sb.close()
    return end, evals, samples, dt


def main() -> int:
    fan_subs = int(os.environ.get("VM_MATSTREAM_SMOKE_SUBS", "16"))
    budget_ms = float(os.environ.get("VM_MATSTREAM_SMOKE_MS", "5"))
    intervals = 4
    from ..httpapi.prometheus_api import PrometheusAPI
    from ..query import rollup_result_cache as rrc
    from ..storage.storage import Storage
    from ..utils import fasttime
    tmp = tempfile.mkdtemp(prefix="vmtpu-matsmoke-")
    s = None
    try:
        s = Storage(tmp)
        now = fasttime.unix_ms()
        t0 = (now - (NN - 1) * SCRAPE) // STEP * STEP
        _seed(s, t0)
        end = t0 + ((NN - 1) * SCRAPE // STEP + 1) * STEP
        rrc.GLOBAL.reset()
        api = PrometheusAPI(s)
        end, evals_1, samples_1, dt_1 = _run(api, s, end, 1, intervals)
        end, evals_n, samples_n, dt_n = _run(api, s, end, fan_subs,
                                             intervals)
        per_sub_ms = max(dt_n - dt_1, 0.0) * 1e3 / (
            intervals * max(fan_subs - 1, 1))
        ok_evals = evals_1 == intervals and evals_n == intervals
        # medians: one interval may straddle a flush; the INVARIANT is
        # that scans do not grow with subscribers
        med_1 = sorted(samples_1)[len(samples_1) // 2]
        med_n = sorted(samples_n)[len(samples_n) // 2]
        ok_flat = med_n <= med_1 * 1.5
        ok_ms = per_sub_ms <= budget_ms
        print(json.dumps({
            "metric": "matstream fan-out smoke "
                      f"(1 vs {fan_subs} subscribers, {intervals} "
                      "intervals)",
            "evals_per_interval": [evals_1 / intervals,
                                   evals_n / intervals],
            "samples_per_interval_median": [med_1, med_n],
            "per_extra_subscriber_ms": round(per_sub_ms, 3),
            "budget_ms": budget_ms,
            "ok": ok_evals and ok_flat and ok_ms,
        }))
        if not ok_evals:
            print("matstream smoke: evals per interval != 1 — the "
                  "shared evaluator is gone", file=sys.stderr)
            return 1
        if not ok_flat:
            print(f"matstream smoke: samples/interval grew with "
                  f"subscribers ({med_1} -> {med_n})", file=sys.stderr)
            return 1
        if not ok_ms:
            print(f"matstream smoke: {per_sub_ms:.2f}ms per extra "
                  f"subscriber (budget {budget_ms}ms)", file=sys.stderr)
            return 1
        return 0
    finally:
        if s is not None:
            try:
                s.close()
            except OSError as e:  # already reported the real outcome
                print(f"matstream smoke: close: {e}", file=sys.stderr)
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
