"""Canonical sample-value formatting shared by the HTTP responders and
count_values-style label generation (strconv.AppendFloat 'g' analog).

The port's copy of ``victoriametrics_tpu/query/format_value.py``, whole.
"""

from __future__ import annotations

import math


def fmt_value(v: float) -> str:
    v = float(v)  # numpy scalars repr as np.float64(...) otherwise
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)
