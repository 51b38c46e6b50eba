"""VictoriaMetrics-native histogram bucketing (reference
vendor/github.com/VictoriaMetrics/metrics/histogram.go:12-30,215-230).

Log-spaced buckets: 18 per decade over [1e-9, 1e18), multiplier
10^(1/18); vmrange labels are "%.3e...%.3e" bounds, with "0...1.000e-09"
and "1.000e+18...+Inf" catch-alls. Shared by the histogram_over_time
rollup and the histogram() aggregate.

The port's copy of ``victoriametrics_tpu/query/vmhistogram.py``, whole.
"""

from __future__ import annotations

import math

E10_MIN = -9
E10_MAX = 18
BUCKETS_PER_DECIMAL = 18
BUCKETS_COUNT = (E10_MAX - E10_MIN) * BUCKETS_PER_DECIMAL

_ranges: list[str] | None = None


def _bucket_ranges() -> list[str]:
    global _ranges
    if _ranges is None:
        out = []
        v = 10.0 ** E10_MIN
        start = f"{v:.3e}"
        for _ in range(BUCKETS_COUNT):
            v *= 10 ** (1.0 / BUCKETS_PER_DECIMAL)
            end = f"{v:.3e}"
            out.append(start + "..." + end)
            start = end
        # benign double-compute: the bucket table is a pure constant,
        # racing fills store equal lists
        _ranges = out  # vmt: disable=VMT015
    return _ranges


LOWER_RANGE = f"0...{10.0 ** E10_MIN:.3e}"
UPPER_RANGE = f"{10.0 ** E10_MAX:.3e}...+Inf"


def vmrange_for(v: float) -> str | None:
    """The vmrange label for one value; None for NaN / negative (which the
    reference histogram skips)."""
    if math.isnan(v) or v < 0:
        return None
    if v == 0:
        return LOWER_RANGE
    if math.isinf(v):
        # +Inf lands in the upper catch-all like the reference (the
        # log10 path below would overflow int())
        return UPPER_RANGE
    idx = (math.log10(v) - E10_MIN) * BUCKETS_PER_DECIMAL
    if idx < 0:
        return LOWER_RANGE
    i = int(idx)
    if idx == float(i) and i > 0:
        # exact 10^n boundaries belong to the lower bucket (le semantics);
        # applied BEFORE the upper-overflow check so exactly 1e18 lands in
        # the last finite bucket like the reference
        i -= 1
    if i >= BUCKETS_COUNT:
        return UPPER_RANGE
    return _bucket_ranges()[i]


def histogram_counts(values) -> dict[str, int]:
    """Non-zero vmrange -> count for a batch of values."""
    out: dict[str, int] = {}
    for v in values:
        r = vmrange_for(float(v))
        if r is not None:
            out[r] = out.get(r, 0) + 1
    return out
