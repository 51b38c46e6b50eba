"""Rollup window grid and the core rollup function set.

The port's copy of the pieces of ``victoriametrics_tpu/ops/rollup_np.py``
that the device engine needs: the static window grid (``RollupConfig``)
and the names of the core rollup functions.  For each output timestamp
``t`` in [start, end] stepping by ``step`` the window is ``(t - window, t]``
(reference rollup.go:688-960).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class RollupConfig:
    """Static window grid: all values unix ms."""
    start: int
    end: int
    step: int
    window: int  # lookbehind; 0 means "use step"

    @property
    def lookback(self) -> int:
        return self.window if self.window > 0 else self.step

    def out_timestamps(self) -> np.ndarray:
        return np.arange(self.start, self.end + 1, self.step, dtype=np.int64)


CORE_SUPPORTED = (
    "count_over_time", "present_over_time", "sum_over_time", "min_over_time",
    "max_over_time", "avg_over_time", "stddev_over_time", "stdvar_over_time",
    "first_over_time", "last_over_time", "default_rollup", "tfirst_over_time",
    "tlast_over_time", "timestamp", "changes", "delta", "increase",
    "increase_pure", "rate", "irate", "idelta", "deriv", "deriv_fast", "lag",
    "lifetime", "scrape_interval",
)
