"""Query-engine core types.

Timeseries: one output series on the shared (start..end, step) grid; NaN
marks absent points (the reference's netstorage.Result shape after rollup).
EvalConfig: the per-query static context threaded through the evaluator
(eval.go evalConfig analog).

The port's copy of ``victoriametrics_tpu/query/types.py``, whole.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..storage.metric_name import MetricName


@dataclasses.dataclass
class Timeseries:
    metric_name: MetricName
    values: np.ndarray  # float64 [T], NaN = absent
    # memoized metric_name.marshal() — set ONLY by producers that know the
    # name will not be mutated downstream (the rollup result cache); may go
    # stale if metric_name is edited, so consumers must treat it as a hint
    raw: bytes | None = None

    def copy_shallow_labels(self) -> "Timeseries":
        mn = MetricName(self.metric_name.metric_group,
                        list(self.metric_name.labels))
        return Timeseries(mn, self.values)


@dataclasses.dataclass
class EvalConfig:
    start: int                 # unix ms, first output timestamp
    end: int                   # unix ms, last output timestamp (inclusive)
    step: int                  # ms
    storage: object = None     # duck-typed: search_series(filters, lo, hi)
    lookback_delta: int = 300_000   # instant-vector staleness window
    max_points_per_series: int = 50_000_000
    max_series: int = 1_000_000
    max_samples_per_query: int = 1_000_000_000  # -search.maxSamplesPerQuery
    max_memory_per_query: int = 0               # -search.maxMemoryPerQuery
    deadline: float = 0.0      # time.monotonic() cutoff; 0 = none
    round_digits: int = 100
    tenant: tuple = (0, 0)     # (accountID, projectID), lib/auth.Token analog
    disable_cache: bool = False  # nocache=1 / -search.disableCache
    # internal: the tail child of an eval-cache partial hit must not read or
    # write the eval rollup cache under its parent's key, but MAY still use
    # the device tile reuse paths (unlike user-facing disable_cache)
    no_eval_cache: bool = False
    # internal: disable the device ROLLING/aux tile-reuse shortcuts while
    # keeping fresh device compute. Set by the HTTP result cache's suffix
    # eval: its VARIABLE-LENGTH suffix grids don't fit the constant-shape
    # sliding advance the resident-window reuse is designed for (the
    # RingBlock declines them), and layering the two tail-merges would
    # double-count coverage. Device engines normally never reach the
    # suffix path for rolling-capable shapes — the serving layer routes
    # them through the resident window first (device_window_ready);
    # this flag covers the remaining fallback evals. Both patterns are
    # pinned by tests/test_served_device_path.py.
    no_device_roll: bool = False
    tracer: object = None      # querytracer.Tracer | NOP (set in __post_init__)
    tpu: object = None         # the device engine when the device path is on
    _grid: np.ndarray | None = None
    _samples_scanned: list | None = None  # shared per-query accumulator
    _partial: list | None = None          # per-query partial-result flag
    # per-query partial-RESOLUTION flag: some fetch was served from a
    # downsampled tier coarser than the query's step allows (raw dropped
    # by retention) — degraded loudly, never silently wrong
    _partial_res: list | None = None
    _cost: object | None = None  # shared per-query CostTracker

    def __post_init__(self):
        if self.tracer is None:
            from ..utils import querytracer
            self.tracer = querytracer.NOP
        if self._samples_scanned is None:
            # created HERE (not lazily) so child() configs made before the
            # first fetch still share one per-query accumulator
            self._samples_scanned = [0]
        if self._partial is None:
            self._partial = [False]
        if self._partial_res is None:
            self._partial_res = [False]
        if self._cost is None:
            # one CostTracker per query, shared by children exactly like
            # the samples accumulator (utils/costacc: the per-query
            # resource-cost plane behind /api/v1/status/usage)
            from ..utils.costacc import CostTracker
            self._cost = CostTracker()
        if self.step <= 0:
            raise ValueError("step must be positive")
        if self.end < self.start:
            raise ValueError("end < start")
        npoints = (self.end - self.start) // self.step + 1
        if npoints > self.max_points_per_series:
            raise ValueError(f"too many output points: {npoints}")

    def timestamps(self) -> np.ndarray:
        if self._grid is None:
            self._grid = np.arange(self.start, self.end + 1, self.step,
                                   dtype=np.int64)
        return self._grid

    @property
    def n_points(self) -> int:
        return self.timestamps().size

    def child(self, **kw) -> "EvalConfig":
        d = dict(start=self.start, end=self.end, step=self.step,
                 storage=self.storage, lookback_delta=self.lookback_delta,
                 max_points_per_series=self.max_points_per_series,
                 max_series=self.max_series, round_digits=self.round_digits,
                 max_samples_per_query=self.max_samples_per_query,
                 max_memory_per_query=self.max_memory_per_query,
                 deadline=self.deadline, tenant=self.tenant,
                 disable_cache=self.disable_cache,
                 no_eval_cache=self.no_eval_cache,
                 no_device_roll=self.no_device_roll,
                 tracer=self.tracer, tpu=self.tpu,
                 _samples_scanned=self._samples_scanned,
                 _partial=self._partial, _partial_res=self._partial_res,
                 _cost=self._cost)
        d.update(kw)
        return EvalConfig(**d)

    def check_deadline(self):
        if self.deadline:
            import time as _t
            if _t.monotonic() > self.deadline:
                from .limits import QueryLimitError
                raise QueryLimitError(
                    "query exceeds -search.maxQueryDuration; increase the "
                    "flag or reduce the query scope")

    @property
    def samples_scanned(self) -> int:
        """Samples fetched so far across all selectors of this query
        (shared accumulator — children report into the parent). The
        O(new-samples) serving regression guard asserts on this."""
        return int(self._samples_scanned[0])

    @property
    def cost(self):
        """The query's shared CostTracker (utils/costacc)."""
        return self._cost

    def count_samples(self, n: int):
        """Accumulate scanned samples across all selectors of one query
        (the -search.maxSamplesPerQuery scope, eval.go seriesFetched).
        Negative n rolls back a fetch whose work was abandoned (e.g. the
        fused device path declining after its fetch)."""
        acc = self._samples_scanned
        acc[0] += n
        self._cost.add_samples(n)
        if acc[0] > self.max_samples_per_query:
            from .limits import QueryLimitError
            raise QueryLimitError(
                f"cannot select more than -search.maxSamplesPerQuery="
                f"{self.max_samples_per_query} samples; the query scans "
                f"{acc[0]} samples so far; possible solutions: to increase "
                f"the -search.maxSamplesPerQuery, to reduce the time range "
                f"or the number of matching series")


def new_series(values: np.ndarray, group: bytes = b"",
               labels: list | None = None) -> Timeseries:
    return Timeseries(MetricName(group, list(labels or [])),
                      np.asarray(values, dtype=np.float64))


def const_series(ec: EvalConfig, v: float) -> Timeseries:
    return new_series(np.full(ec.n_points, v, dtype=np.float64))
