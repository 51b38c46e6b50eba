"""The flagship device pipeline: aggr(rollup(selector[window])) over one
tile, the port of ``victoriametrics_tpu/models/rollup_pipeline.py``.

`QueryPipeline` binds the static query shape (window grid, rollup func,
aggregate, group count) and runs the fused kernel (K2) on tensors:

- forward(ts, values, counts, group_ids) -> [G, T]   one device
- sharded(mesh)(ts, values, counts, group_ids) -> [G, T]   series-sharded
  (B13: each shard's moments, combined in shard order)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.device_rollup import (MIN_TS_NONE, group_layout, pack_series,
                                 rollup_aggregate_tile)
from ..ops.rollup_np import RollupConfig
from ..parallel import mesh as meshlib
from ..parallel.partition import AXIS_SERIES, split_rows


@dataclasses.dataclass(frozen=True)
class QueryPipeline:
    cfg: RollupConfig
    rollup_func: str = "rate"
    aggr: str = "sum"
    num_groups: int = 256

    def forward(self, ts, values, counts, group_ids):
        """Tensors on one device -> float64 [G, T] on that device."""
        groups = group_layout(group_ids, self.num_groups, ts.device)
        return rollup_aggregate_tile(self.rollup_func, self.aggr, ts, values,
                                     counts, groups, self.cfg)

    def sharded(self, mesh):
        """forward over a series-sharded mesh: the returned function takes
        whole tensors (rows a multiple of the series axis, split into row
        blocks) or per-shard lists, and returns float64 [G, T] on the
        mesh's first device."""
        fn = meshlib.sharded_rollup_aggregate(
            mesh, self.rollup_func, self.aggr, self.cfg, self.num_groups)

        def run(ts, values, counts, group_ids):
            ts, values, counts, group_ids = (
                x if isinstance(x, list) else
                split_rows(mesh, AXIS_SERIES, torch.as_tensor(x))
                for x in (ts, values, counts, group_ids))
            groups = [group_layout(g, self.num_groups, t.device)
                      for g, t in zip(group_ids, ts)]
            return fn(ts, values, counts, groups, 0, MIN_TS_NONE)
        return run


def synth_workload(n_series: int, n_samples: int, cfg: RollupConfig,
                   num_groups: int, seed: int = 0):
    """Synthetic TSBS-devops-like tile (numpy): counter series at 15s-ish
    intervals, grouped n_series/num_groups-to-1 (the `by (instance)`
    shape).  Same generator as the reference, float64 values."""
    rng = np.random.default_rng(seed)
    interval = max((cfg.end - cfg.start) // max(n_samples - 1, 1), 1)
    base = np.arange(n_samples, dtype=np.int64) * interval + cfg.start
    series = []
    for _ in range(n_series):
        ts = base + rng.integers(-interval // 4, interval // 4 + 1, n_samples)
        ts.sort()
        v = np.cumsum(rng.integers(0, 50, n_samples)).astype(np.float64)
        series.append((ts, v))
    ts_t, v_t, counts = pack_series(series, cfg.start)
    gids = (np.arange(n_series) % num_groups).astype(np.int32)
    return ts_t, v_t, counts, gids
