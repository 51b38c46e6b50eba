"""Downsample tier read-path smoke (tools/lint.sh gate): the background
re-rollup machinery and the tier-selecting read path must not rot
between full pytest runs.

One in-process pass against a real Storage (~3s):

1. ingest 2 days of 60s raw data (3 series) aged well past the 1d tier
   offset, flush, run one downsample cycle;
2. the 5m tier must exist on disk and the pass metrics must tick;
3. a long-range fetch with a downsample hint must be served FROM the
   tier: ``ds_res`` == 5m and the raw oracle reads >=4x more samples
   (60s -> 5m buckets is 5x);
4. ``sum_over_time`` over a bucket-aligned grid must be BIT-EXACT
   between the tier-served path and the raw oracle
   (``VM_DOWNSAMPLE_READ=0``), with no partial-resolution flag.

Exit 0 on success, 1 on any violated invariant.
``VMT_NO_DOWNSAMPLE_SMOKE=1`` skips from tools/lint.sh.

The port's copy of ``victoriametrics_tpu/devtools/downsample_smoke.py``,
whole.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np

NOW = 1_754_000_000_000
RES = 300_000                     # 5m tier resolution
STEP = 3_600_000                  # 1h query step (bucket-aligned)


def _fail(msg: str) -> int:
    print(f"downsample smoke: FAIL: {msg}")
    return 1


def _run_query(s, start, end):
    from ..query.exec import exec_query
    from ..query.types import EvalConfig
    s.reset_partial()
    ec = EvalConfig(start=start, end=end, step=STEP, storage=s,
                    disable_cache=True)
    rows = exec_query(ec, "sum_over_time(m[1h])")
    return ({bytes(r.metric_name.marshal()): r.values for r in rows}, ec)


def main() -> int:
    from ..storage.storage import Storage
    from ..storage.tag_filters import TagFilter
    from ..utils import metrics as metricslib

    rows_out = metricslib.REGISTRY.counter("vm_downsample_rows_out_total")
    tmp = tempfile.mkdtemp(prefix="ds-smoke-")
    base = NOW - 10 * 86_400_000
    try:
        s = Storage(os.path.join(tmp, "s"), retention_ms=10 ** 15,
                    downsample="1d:5m")
        rows = []
        for i in range(0, 2 * 86_400_000, 60_000):
            for k in range(3):
                rows.append(({"__name__": "m", "i": str(k)}, base + i,
                             float((i // 60_000 + k) % 997)))
        s.add_rows(rows)
        s.table.flush_to_disk()
        s.run_downsample_cycle(now_ms=NOW)
        if rows_out.get() <= 0:
            return _fail("downsample cycle produced no tier rows")

        # 3. long-range fetch with a hint is served from the 5m tier
        flt = [TagFilter(b"", b"m")]
        lo, hi = base, base + 2 * 86_400_000
        s.reset_partial()
        cols = s.search_columns(flt, lo, hi, ds=("sum", STEP))
        raw = s.search_columns(flt, lo, hi)
        if cols.ds_res != RES:
            return _fail(f"hinted fetch not tier-served (ds_res="
                         f"{cols.ds_res}, want {RES})")
        if raw.n_samples < 4 * max(cols.n_samples, 1):
            return _fail(f"tier read not cheaper: raw={raw.n_samples} "
                         f"tier={cols.n_samples} samples")
        ratio = raw.n_samples / max(cols.n_samples, 1)
        print(f"downsample smoke: tier serves {cols.n_samples} samples "
              f"vs {raw.n_samples} raw ({ratio:.1f}x fewer)")

        # 4. bit-exact oracle equality on a bucket-aligned grid
        start = ((base // RES) + 2) * RES
        start += (STEP - (start % STEP)) % STEP
        tier, ec = _run_query(s, start, hi)
        if ec._partial_res[0]:
            return _fail("tier-served query flagged partial-resolution")
        os.environ["VM_DOWNSAMPLE_READ"] = "0"
        try:
            oracle, _ = _run_query(s, start, hi)
        finally:
            del os.environ["VM_DOWNSAMPLE_READ"]
        if tier.keys() != oracle.keys() or len(tier) != 3:
            return _fail("series sets differ between tier and raw oracle")
        for k in sorted(tier):
            a, b = tier[k], oracle[k]
            if not (np.isnan(a) == np.isnan(b)).all():
                return _fail("NaN grids differ between tier and oracle")
            m = ~np.isnan(a)
            if not (a[m] == b[m]).all():
                return _fail("sum_over_time not bit-exact vs raw oracle")
        print("downsample smoke: PASS (tier served, oracle bit-exact)")
        s.close()
        return 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    raise SystemExit(main())
