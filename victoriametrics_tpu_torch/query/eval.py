"""The MetricsQL evaluator (reference app/vmselect/promql/eval.go:279-1900).

Walks the AST producing lists of Timeseries on the shared output grid.
Rollups fetch raw samples from storage and window them (oracle/NumPy host
path; the device path in cuda_engine.py takes over for supported
per-series, aggr(rollup(selector)) and topk shapes when EvalConfig.tpu
holds a CUDAEngine).

The port's copy of ``victoriametrics_tpu/query/eval.py``, whole.  It
differs only at the device seams: every dispatch goes to
``cuda_engine`` (``try_rollup``, ``try_aggr_rollup``,
``try_quantile_rollup``, ``try_topk_rollup``, ``advance_rolling``,
``run_fused_on_tiles``, ``run_quantile_on_tiles``); a query's groups
reach the kernels as ``cuda_engine.groups_for`` layouts (and a
quantile's slots as a tensor on the engine's device) instead of the
reference's arrays; the rolling window is filed by
``cuda_engine.register_window``; and limitk's name hash is
``native.xxh64`` instead of the ``xxhash`` package.  A kernel that fails to build or launch fails the query: no
engine call is wrapped in a ``try``.
"""

from __future__ import annotations

import numpy as np

from ..ops.rollup_np import RollupConfig
from ..storage.metric_name import MetricName
from ..storage.tag_filters import TagFilter
from .aggr_funcs import (PER_SERIES, SIMPLE, a_quantile, series_rank_metric,
                         topk_mask_per_ts)
from .binary_op import ARITH_OPS, CMP_OPS, eval_binary_op
from .metricsql.ast import (AggrFuncExpr, BinaryOpExpr, DurationExpr, Expr,
                            FuncExpr, LabelFilter, MetricExpr, NumberExpr,
                            RollupExpr, StringExpr)
from .rollup_funcs import (GENERIC_FUNCS, KEEP_METRIC_NAMES, MULTI_FUNCS,
                           ORACLE_FUNCS, ROLLUP_FUNC_NAMES,
                           adjusted_windows, rollup_series)
from .transform_funcs import TRANSFORM_FUNCS
from .types import EvalConfig, Timeseries, const_series, new_series

nan = np.nan

# host-rollup share of vm_fetch_phase_seconds_total (storage/storage.py
# owns the fetch-side phases; bench.py reads the whole family to
# attribute a refresh between index/collect/decode/assemble/rollup)
def _rollup_phase_lap(t0: float) -> None:
    import time as _t

    from ..utils import costacc as _costacc
    from ..utils import flightrec as _flightrec
    from ..utils import metrics as _metricslib
    now = _t.perf_counter()
    _metricslib.REGISTRY.float_counter(
        'vm_fetch_phase_seconds_total{phase="rollup"}').inc(now - t0)
    _flightrec.rec("fetch:rollup", t0, now - t0)
    _costacc.lap("fetch:rollup", now - t0)


class QueryError(ValueError):
    pass


def _tag_filters(fs) -> list[TagFilter]:
    out = []
    for f in fs:
        key = b"" if f.label == "__name__" else f.label.encode()
        out.append(TagFilter(key, f.value.encode(), negate=f.is_negative,
                             regex=f.is_regexp))
    return out


def filter_sets_from_metric_expr(me: MetricExpr) -> list[list[TagFilter]]:
    """All OR'd filter sets of a selector as storage TagFilter lists."""
    return [_tag_filters(fs) for fs in me.filter_sets()]


def filters_from_metric_expr(me: MetricExpr, storage=None):
    """Storage-facing filters for a selector: a plain list[TagFilter] for
    the common single-set case; a list of filter SETS for `{a="b" or
    c="d"}` selectors (plain Storage unions them at the tsid level —
    supports_filter_union).  Backends without union support fail loudly
    instead of silently matching only the first set."""
    sets = filter_sets_from_metric_expr(me)
    if len(sets) == 1:
        return sets[0]
    if storage is not None and \
            not getattr(storage, "supports_filter_union", False):
        raise QueryError(
            "selector-level `or` filters are not supported by this "
            "storage backend yet; rewrite the query as `expr_a or expr_b`")
    return sets


def eval_expr(ec: EvalConfig, e: Expr) -> list[Timeseries]:
    if isinstance(e, NumberExpr):
        return [const_series(ec, e.value)]
    if isinstance(e, DurationExpr):
        return [const_series(ec, e.value_ms(ec.step) / 1e3)]
    if isinstance(e, StringExpr):
        return []  # bare string literals evaluate to no series (exec_test)
    if isinstance(e, MetricExpr):
        re_ = RollupExpr(expr=e)
        return _eval_rollup_expr(ec, "default_rollup", re_, ())
    if isinstance(e, RollupExpr):
        return _eval_rollup_expr(ec, "default_rollup", e, ())
    if isinstance(e, FuncExpr):
        return _eval_func(ec, e)
    if isinstance(e, AggrFuncExpr):
        return _eval_aggr(ec, e)
    if isinstance(e, BinaryOpExpr):
        return _eval_binary(ec, e)
    raise QueryError(f"cannot evaluate {type(e).__name__}")


# ---------------------------------------------------------------------------
# Functions
# ---------------------------------------------------------------------------

def _eval_func(ec: EvalConfig, fe: FuncExpr) -> list[Timeseries]:
    name = fe.name
    if name in ROLLUP_FUNC_NAMES:
        return _eval_rollup_func(ec, fe)
    tf = TRANSFORM_FUNCS.get(name)
    if tf is None:
        raise QueryError(f"unknown function {name!r}")
    args = []
    for a in fe.args:
        if isinstance(a, StringExpr):
            args.append(a.value)
        else:
            # everything else is a series list; scalar params unwrap via
            # _scalar_arg (const scalars become 1-series constants)
            args.append(eval_expr(ec, a))
    out = tf(ec, args)
    if fe.keep_metric_names:
        srcs = [a for a in args if isinstance(a, list)]
        if srcs and len(srcs[0]) == len(out):
            for ts, src in zip(out, srcs[0]):
                ts.metric_name.metric_group = src.metric_name.metric_group
                ts.raw = None  # in-place name edit: memo is stale
    return out


# ---------------------------------------------------------------------------
# Rollups
# ---------------------------------------------------------------------------

def _find_rollup_arg_idx(fe: FuncExpr) -> int:
    spec = GENERIC_FUNCS.get(fe.name)
    if spec is not None and spec[0] is not None:
        return spec[2]
    if fe.name in ("quantiles_over_time", "aggr_over_time",
                   "count_values_over_time"):
        return len(fe.args) - 1
    return 0


def _eval_rollup_func(ec: EvalConfig, fe: FuncExpr) -> list[Timeseries]:
    if not fe.args:
        raise QueryError(f"{fe.name} needs arguments")
    ridx = _find_rollup_arg_idx(fe)
    if ridx >= len(fe.args):
        raise QueryError(f"{fe.name}: missing rollup argument")
    rarg = fe.args[ridx]
    if isinstance(rarg, MetricExpr):
        rarg = RollupExpr(expr=rarg)
    elif not isinstance(rarg, RollupExpr):
        rarg = RollupExpr(expr=rarg)  # subquery over inner expr

    # extra scalar/string args (quantile phi, predict_linear t, ...)
    extra = []
    for i, a in enumerate(fe.args):
        if i == ridx:
            continue
        if isinstance(a, StringExpr):
            extra.append(a.value)
        elif isinstance(a, FuncExpr) and a.name == "union" and \
                all(isinstance(x, StringExpr) for x in a.args):
            # ("fn1", "fn2", ...) function-name lists (aggr_over_time)
            extra.extend(x.value for x in a.args)
        else:
            extra.append(float(eval_expr(ec, a)[0].values[0]))

    if fe.name == "aggr_over_time":
        funcs = [a for a in extra if isinstance(a, str)]
        out = []
        for f in funcs:
            sub = _eval_rollup_expr(ec, f, rarg, ())
            for ts in sub:
                ts.metric_name.labels.append((b"rollup", f.encode()))
                ts.metric_name.sort_labels()
                ts.raw = None  # memoized marshal is stale now
            out.extend(sub)
        return out

    if fe.name == "quantiles_over_time":
        dst_label = extra[0] if extra and isinstance(extra[0], str) else "phi"
        phis = [a for a in extra if isinstance(a, float)]
        out = []
        for phi in phis:
            sub = _eval_rollup_expr(ec, "quantile_over_time", rarg, (phi,),
                                    keep_name=True)
            for ts in sub:
                ts.metric_name.labels.append(
                    (dst_label.encode(), repr(phi).encode()))
                ts.metric_name.sort_labels()
                ts.raw = None  # memoized marshal is stale now
            out.extend(sub)
        return out

    if fe.name == "absent_over_time":
        rows = _eval_rollup_expr(ec, "absent_over_time", rarg, ())
        return _aggregate_absent_over_time(ec, rarg.expr, rows)

    if fe.name in ("count_values_over_time", "histogram_over_time"):
        return _eval_multi_value_rollup(ec, fe.name, rarg, extra,
                                        fe.keep_metric_names)

    if fe.name in MULTI_FUNCS:
        # rollup.go:413 appendRollupConfigs: an explicit 2nd arg ("min" /
        # "max" / "avg", or candlestick's leg name) selects ONE output and —
        # except for rollup_candlestick — suppresses the `rollup` tag.
        out = []
        tags = MULTI_FUNCS[fe.name]
        explicit = extra[0] if extra and isinstance(extra[0], str) else None
        keep = fe.keep_metric_names or fe.name in KEEP_METRIC_NAMES
        if fe.name == "rollup_candlestick":
            if explicit is not None:
                legs = dict(tags)
                if explicit not in legs:
                    raise QueryError(
                        f"unexpected second arg for {fe.name}: {explicit!r}")
                tags = [(explicit, legs[explicit])]
            # eval.go:943: auto `offset -step` — evaluate one step forward
            # (shifting the inner subquery grid too), relabel back
            ec2 = ec.child(start=ec.start + ec.step, end=ec.end + ec.step)
            for tag, _ in tags:
                sub = _eval_rollup_expr(ec2, "rollup_candlestick", rarg,
                                        (tag,), keep_name=keep)
                for ts in sub:
                    ts.metric_name.labels.append((b"rollup", tag.encode()))
                    ts.metric_name.sort_labels()
                    ts.raw = None  # memoized marshal is stale now
                out.extend(sub)
            return out
        if explicit is not None and explicit not in ("min", "max", "avg"):
            raise QueryError(
                f"unexpected second arg for {fe.name}: {explicit!r}; "
                "want `min`, `max` or `avg`")
        sel = [t for t, _ in tags] if explicit is None else [explicit]
        for tag in sel:
            sub = _eval_rollup_expr(ec, fe.name, rarg, (tag,), keep_name=keep)
            if explicit is None:
                for ts in sub:
                    ts.metric_name.labels.append((b"rollup", tag.encode()))
                    ts.metric_name.sort_labels()
                    ts.raw = None  # memoized marshal is stale now
            out.extend(sub)
        return out

    keep = fe.keep_metric_names or fe.name in KEEP_METRIC_NAMES
    return _eval_rollup_expr(ec, fe.name, rarg, tuple(extra), keep_name=keep)


def _eval_at(ec: EvalConfig, at_expr: Expr) -> int:
    v = float(eval_expr(ec, at_expr)[0].values[0])
    return int(v * 1e3)


def _eval_rollup_expr(ec: EvalConfig, func: str, re_: RollupExpr,
                      args: tuple, keep_name: bool | None = None
                      ) -> list[Timeseries]:
    if keep_name is None:
        keep_name = func in KEEP_METRIC_NAMES
    offset = re_.offset.value_ms(ec.step) if re_.offset is not None else 0
    window = re_.window.value_ms(ec.step) if re_.window is not None else 0

    at_ts = _eval_at(ec, re_.at) if re_.at is not None else None
    if at_ts is not None:
        # evaluate at the fixed timestamp, then broadcast over the grid
        sub_ec = ec.child(start=at_ts, end=at_ts, step=ec.step)
        rows = _eval_rollup_expr(sub_ec, func,
                                 RollupExpr(expr=re_.expr, window=re_.window,
                                            step=re_.step,
                                            inherit_step=re_.inherit_step,
                                            offset=re_.offset),
                                 args, keep_name)
        T = ec.n_points
        return [Timeseries(ts.metric_name,
                           np.full(T, ts.values[0]))
                for ts in rows]

    if isinstance(re_.expr, MetricExpr) and not re_.needs_subquery():
        return _rollup_from_storage(ec, func, re_, window, offset, args,
                                    keep_name)
    return _rollup_subquery(ec, func, re_, window, offset, args, keep_name)


def _fetch_for_rollup(ec: EvalConfig, func: str, re_: RollupExpr,
                      window: int, offset: int, fetcher, trace_label: str):
    """Shared fetch bookkeeping for both rollup fetch shapes (per-series
    and columnar): deadline, -search.maxSamplesPerQuery, rollup memory
    admission (eval.go:1776-1885), partial-result capture, tracing.

    `fetcher(filters, lo, hi, qt)` performs the storage search plus any
    stale-sample handling and returns (payload, n_series, n_samples); `qt`
    is the fetch span (cluster storages thread it through the RPC so
    storage-node spans graft under it); the caller holds the returned
    `admission` while computing the rollup."""
    from .limits import admit_rollup
    me: MetricExpr = re_.expr
    if ec.storage is None:
        raise QueryError("no storage attached to the query engine")
    ec.check_deadline()
    lookback = window if window > 0 else (
        ec.lookback_delta if func == "default_rollup" else ec.step)
    start = ec.start - offset
    end = ec.end - offset
    fetch_lo = start - lookback - ec.lookback_delta
    # device tile identity: the ACTUAL fetch bounds plus the data version
    # read BEFORE the fetch — a concurrent ingest then caches under the old
    # version and the next query rebuilds (never serves mid-write tiles as
    # current)
    fetch_info = (fetch_lo, end,
                  getattr(ec.storage, "data_version", None))
    filters = filters_from_metric_expr(me, ec.storage)
    with ec.tracer.new_child(trace_label + " %s window=%dms", me,
                             lookback) as qt:
        try:
            payload, n_series, n_samples = fetcher(filters, fetch_lo, end,
                                                   qt)
        except ResourceWarning as e:
            from .limits import QueryLimitError
            raise QueryLimitError(
                f"{e}; either narrow the selector or raise "
                f"-search.maxUniqueTimeseries") from None
        if getattr(ec.storage, "last_partial", False):
            # capture partiality PER QUERY right after the fetch: the
            # shared storage flag is reset by every new incoming request
            ec._partial[0] = True
        if getattr(ec.storage, "last_partial_resolution", False):
            # a downsampled tier coarser than the query's step served a
            # range whose raw data is gone (see storage/downsample.py)
            ec._partial_res[0] = True
        ec.count_samples(n_samples)
        qt.donef("%d series, %d samples", n_series, n_samples)
    cfg = RollupConfig(start=start, end=end, step=ec.step, window=lookback)
    admission = admit_rollup(str(me), n_series, ec.n_points,
                             ec.max_memory_per_query)
    return payload, cfg, admission, fetch_info


# Rollup func -> the downsampled-tier aggregate column that can serve it
# (storage/downsample.py AGG_COLUMNS).  "last" is literally query-time
# dedup at the tier resolution, so funcs that consume raw samples
# (rate/increase/delta/default_rollup) read it as a coarser sample
# stream; count reads the per-bucket count column (summed — see the
# count->sum rewrite); avg composes sum/count.
_DS_AGG = {
    "min_over_time": "min", "max_over_time": "max",
    "sum_over_time": "sum", "count_over_time": "count",
    "avg_over_time": "avg",
    "last_over_time": "last", "default_rollup": "last",
    "rate": "last", "increase": "last", "delta": "last",
}


def _ds_hint(ec: EvalConfig, func: str, window: int):
    """``(agg_column, max_resolution_ms)`` when this rollup may be served
    from downsampled tiers, else None.  The resolution bound is the
    rollup's effective lookback: every window then spans at least one
    whole tier bucket.  None whenever the storage has no tiers or
    VM_DOWNSAMPLE_READ=0 (the raw-oracle escape hatch)."""
    st = ec.storage
    if st is None or not getattr(st, "supports_downsample_read", False):
        return None
    if not st.downsample_active:
        return None
    from ..storage import downsample as _dsmod
    if not _dsmod.read_enabled():
        return None
    agg = _DS_AGG.get(func)
    if agg is None:
        return None
    lookback = window if window > 0 else (
        ec.lookback_delta if func == "default_rollup" else ec.step)
    if lookback <= 0:
        return None
    return (agg, int(lookback))


def _tracer_kw(ec: EvalConfig, qt) -> dict:
    """Thread the fetch span AND the query deadline through storages
    that can propagate them over RPC (ClusterStorage); plain storages
    take neither kwarg.  The deadline makes every per-node socket
    timeout a function of the query's REMAINING budget — a hung
    vmstorage costs one deadline, not a fixed timeout per hop."""
    kw = {}
    if qt.enabled and getattr(ec.storage, "supports_search_tracer", False):
        kw["tracer"] = qt
    if ec.deadline and getattr(ec.storage, "supports_search_deadline",
                               False):
        import time as _t
        remaining = ec.deadline - _t.monotonic()
        if remaining > 0:
            # reserve 20% of the remaining budget for the rollup/merge
            # tail: a stalled node then costs ~0.8 deadlines and the
            # surviving nodes' PARTIAL result still computes and serves
            # inside the query deadline, instead of the fetch eating the
            # whole budget and the post-fetch check failing the query
            kw["deadline"] = ec.deadline - 0.2 * remaining
        else:
            kw["deadline"] = ec.deadline  # exhausted: fail fast in rpc
    return kw


def _fetch_series_for_rollup(ec: EvalConfig, func: str, re_: RollupExpr,
                             window: int, offset: int):
    def fetcher(filters, lo, hi, qt):
        series = ec.storage.search_series(filters, lo, hi,
                                          max_series=ec.max_series,
                                          tenant=ec.tenant,
                                          **_tracer_kw(ec, qt))
        series = _drop_stale_nans(func, series)
        return series, len(series), sum(s.timestamps.size for s in series)

    return _fetch_for_rollup(ec, func, re_, window, offset, fetcher,
                             "fetch")


def _fetch_columns_for_rollup(ec: EvalConfig, func: str, re_: RollupExpr,
                              window: int, offset: int, ds=None):
    """Columnar twin of _fetch_series_for_rollup: one batched decode pass
    into padded (S, N) columns (storage.search_columns).  ``ds`` is the
    optional downsampled-tier hint (see _ds_hint), passed through only
    when set — plain storages without tier support never see the kwarg."""
    def fetcher(filters, lo, hi, qt):
        kw = _tracer_kw(ec, qt)
        if ds is not None:
            kw["ds"] = ds
        cols = ec.storage.search_columns(filters, lo, hi,
                                         max_series=ec.max_series,
                                         tenant=ec.tenant, **kw)
        if func not in ("default_rollup", "stale_samples_over_time"):
            cols.drop_stale_nans()  # dropStaleNaNs (eval.go:2081), batched
        return cols, cols.n_series, cols.n_samples

    return _fetch_for_rollup(ec, func, re_, window, offset, fetcher,
                             "fetch cols")


def _finish_rollup_cols(cols, rows, keep_name: bool) -> list[Timeseries]:
    return _finish_rollup_names(cols.metric_names, rows, keep_name,
                                cols.raw_names)


def _rollup_from_storage_cols(ec: EvalConfig, func: str, re_: RollupExpr,
                              window: int, offset: int, args: tuple,
                              keep_name: bool, ckey,
                              ds=None) -> list[Timeseries]:
    """Columnar host rollup: fetch -> (S, N) columns -> batched rollup,
    zero per-series Python on the hot path.  With a ``ds`` hint the fetch
    may return tier aggregate columns; count_over_time then computes as
    sum_over_time (count column per aged bucket + 1-per-raw-sample tail —
    see downsample.count_tail_piece — sum to the true count)."""
    from ..ops import rollup_np
    if ds is not None and ds[0] == "avg":
        return _ds_avg_composed(ec, re_, window, offset, args, keep_name,
                                ckey, ds)
    cols, cfg, admission, _ = _fetch_columns_for_rollup(
        ec, func, re_, window, offset, ds)
    if ds is not None and ds[0] == "count":
        func = "sum_over_time"
    per_series_cfg = None
    adj = adjusted_windows(func, window, ec.step, cols.ts_list())
    if adj:
        if all(a == adj[0] for a in adj):
            cfg = RollupConfig(start=cfg.start, end=cfg.end, step=cfg.step,
                               window=adj[0])
        else:
            per_series_cfg = [RollupConfig(start=cfg.start, end=cfg.end,
                                           step=cfg.step, window=a)
                              for a in adj]
    with admission:
        import time as _time
        t0r = _time.perf_counter()
        if per_series_cfg is None:
            with ec.tracer.new_child("host rollup %s (columns)",
                                     func) as qt:
                rows = rollup_np.rollup_batch_packed(func, cols.ts,
                                                     cols.vals, cols.counts,
                                                     cfg, args)
                if rows is not None:
                    _rollup_phase_lap(t0r)
                    qt.donef("%d series (packed)", cols.n_series)
                    return _cache_rollup(ec, ckey,
                                         _finish_rollup_cols(cols, rows,
                                                             keep_name))
                qt.donef("fell back to per-series (non-finite values)")
        with ec.tracer.new_child("host rollup %s (per-series)", func) as qt:
            out_rows = []
            counts = cols.counts
            for i in range(cols.n_series):
                if i % 256 == 0:
                    ec.check_deadline()
                n = int(counts[i])
                c = per_series_cfg[i] if per_series_cfg is not None else cfg
                out_rows.append(rollup_series(func, cols.ts[i, :n],
                                              cols.vals[i, :n], c, args))
            _rollup_phase_lap(t0r)
            qt.donef("%d series", cols.n_series)
        return _cache_rollup(ec, ckey,
                             _finish_rollup_cols(cols, out_rows, keep_name))


def _ds_avg_composed(ec: EvalConfig, re_: RollupExpr, window: int,
                     offset: int, args: tuple, keep_name: bool, ckey,
                     ds) -> list[Timeseries]:
    """avg_over_time over downsampled tiers: sum column / count column.
    A per-bucket average cannot be re-averaged correctly (buckets hold
    different sample counts); the sum/count pair can.  The composition
    is correct even when raw ends up serving the fetch: the count leg
    then reads 1-per-sample (downsample.count_tail_piece), so the
    division still yields the exact raw average."""
    sums = _rollup_from_storage_cols(ec, "sum_over_time", re_, window,
                                     offset, args, keep_name, None,
                                     ds=("sum", ds[1]))
    cnts = _rollup_from_storage_cols(ec, "count_over_time", re_, window,
                                     offset, args, keep_name, None,
                                     ds=("count", ds[1]))
    by_key = {bytes(ts.metric_name.marshal()): ts for ts in cnts}
    out = []
    for ts in sums:
        c = by_key.get(bytes(ts.metric_name.marshal()))
        if c is None:
            continue
        with np.errstate(invalid="ignore", divide="ignore"):
            vals = np.where(c.values > 0, ts.values / c.values, nan)
        out.append(Timeseries(ts.metric_name, vals))
    return _cache_rollup(ec, ckey, out)


def _rollup_from_storage(ec: EvalConfig, func: str, re_: RollupExpr,
                         window: int, offset: int, args: tuple,
                         keep_name: bool) -> list[Timeseries]:
    me: MetricExpr = re_.expr
    if me.is_empty():
        return []

    # eval-level per-expression rollup cache (rollup_result_cache.go:283):
    # repeated and rolling evaluations of the same rollup recompute only
    # the uncovered tail, independent of the enclosing query
    use_cache = (ec.n_points > 1 and func != "default_rollup"
                 and offset >= 0 and not ec.disable_cache
                 and not ec.no_eval_cache)
    ckey = None
    if use_cache:
        import time as _t

        from .rollup_result_cache import GLOBAL as rcache
        now_ms = int(_t.time() * 1000)
        # the ds token splits cache entries computed with tier serving on
        # vs off (VM_DOWNSAMPLE_READ flips live; tier floats differ from
        # raw floats, so the two populations must never merge)
        ckey = (f"rollup|{func}|{me}|{window}|{offset}|{args!r}|"
                f"{keep_name}|"
                f"ds{0 if _ds_hint(ec, func, window) is None else 1}")
        cached, new_start = rcache.get(ec, ckey, now_ms)
        if cached is not None and new_start > ec.end:
            ec.tracer.printf("eval rollup cache: full hit %s", ckey)
            return cached.rows()
        if cached is not None:
            ec.tracer.printf("eval rollup cache: tail from %d", new_start)
            sub_start, trim = suffix_child_bounds(ec, new_start)
            sub = ec.child(start=sub_start)
            sub.no_eval_cache = True  # the suffix must not clobber ckey
            fresh = _rollup_from_storage(sub, func, re_, window, offset,
                                         args, keep_name)
            if trim:
                fresh = trim_suffix_rows(fresh)
            rows = rcache.merge(cached, fresh, ec, new_start,
                                now_ms=now_ms)
            if not ec._partial[0] and not ec._partial_res[0]:
                rcache.put(ec, ckey, rows, now_ms)
            return rows

    from ..ops import rollup_np as _rnp
    if (ec.tpu is None and ec.storage is not None
            and _rnp.batch_supported(func, args)
            and getattr(ec.storage, "search_columns", None) is not None):
        # columnar host path: batched decode -> packed rollup, no
        # per-series materialization (device tiles go through the series
        # path below so tile caching keys stay unified)
        return _rollup_from_storage_cols(ec, func, re_, window, offset,
                                         args, keep_name, ckey,
                                         ds=_ds_hint(ec, func, window))

    series, cfg, admission, fetch_info = _fetch_series_for_rollup(
        ec, func, re_, window, offset)
    per_series_cfg = None
    adj = adjusted_windows(func, window, ec.step,
                           [sd.timestamps for sd in series])
    if adj:
        if all(a == adj[0] for a in adj):
            cfg = RollupConfig(start=cfg.start, end=cfg.end, step=cfg.step,
                               window=adj[0])
        else:
            per_series_cfg = [RollupConfig(start=cfg.start, end=cfg.end,
                                           step=cfg.step, window=a)
                              for a in adj]
    with admission:
        if per_series_cfg is not None:
            # windows differ per series: per-series host loop
            with ec.tracer.new_child("host rollup %s (per-series window)",
                                     func) as qt:
                out_rows = []
                for i, (sd, c) in enumerate(zip(series, per_series_cfg)):
                    if i % 256 == 0:
                        ec.check_deadline()
                    out_rows.append(rollup_series(func, sd.timestamps,
                                                  sd.values, c, args))
                qt.donef("%d series", len(out_rows))
            return _cache_rollup(ec, ckey,
                                 _finish_rollup(series, out_rows,
                                                keep_name))
        if ec.tpu is not None:
            from .cuda_engine import try_rollup
            with ec.tracer.new_child("tpu rollup %s", func) as qt:
                got = try_rollup(ec.tpu, func, series, cfg, args,
                                 cache_key=_tile_cache_key(ec, me, cfg,
                                                           fetch_info))
                if got is not None:
                    qt.donef("device path, %d series", len(got))
                    return _cache_rollup(ec, ckey,
                                         _finish_rollup(series, got,
                                                        keep_name))
                qt.donef("fell back to host")

        with ec.tracer.new_child("host rollup %s", func) as qt:
            if len(series) >= 8 and _rnp.batch_supported(func, args):
                from ..ops import rollup_np
                rows = rollup_np.rollup_batch(
                    func, [(sd.timestamps, sd.values) for sd in series],
                    cfg, args)
                if rows is not None:
                    qt.donef("%d series (batched)", len(series))
                    return _cache_rollup(
                        ec, ckey, _finish_rollup(series, list(rows),
                                                 keep_name))
            out_rows = []
            for i, sd in enumerate(series):
                if i % 256 == 0:
                    ec.check_deadline()
                vals = rollup_series(func, sd.timestamps, sd.values, cfg,
                                     args)
                out_rows.append(vals)
            qt.donef("%d series", len(out_rows))
        return _cache_rollup(ec, ckey,
                             _finish_rollup(series, out_rows, keep_name))


def _aggregate_absent_over_time(ec: EvalConfig, expr,
                                rows: list[Timeseries]) -> list[Timeseries]:
    """Collapse per-series absent windows into one series: 1 only where NO
    matching series has a sample (eval.go:990 aggregateAbsentOverTime);
    labels come from the selector's literal equality filters."""
    labels = []
    # selector labels apply only for a SINGLE filter set: with OR'd sets
    # there is no one label combination that "was absent" (the reference
    # applies them only when len(labelFilterss) == 1)
    if isinstance(expr, MetricExpr) and not expr.or_sets:
        for f in expr.label_filters:
            if not f.is_negative and not f.is_regexp and \
                    f.label != "__name__":
                labels.append((f.label.encode(), f.value.encode()))
    out = Timeseries(MetricName(b"", sorted(labels)),
                     np.ones(ec.n_points, dtype=np.float64))
    for ts in rows:
        # a NaN in the per-series absent rollup means the series HAS a
        # sample there — so the collapsed result must be NaN too
        out.values[np.isnan(ts.values)] = nan
    return [out]


def _eval_multi_value_rollup(ec: EvalConfig, func: str, re_: RollupExpr,
                             extra: list,
                             keep_name: bool = False) -> list[Timeseries]:
    """count_values_over_time("label", m[d]) and histogram_over_time(m[d]):
    one output series per distinct value / vmrange bucket per input series
    (rollup.go:1490 newRollupCountValues, :1526 rollupHistogram)."""
    dst_label = b""
    if func == "count_values_over_time":
        if not extra or not isinstance(extra[0], str):
            raise QueryError("count_values_over_time needs a label name")
        dst_label = extra[0].encode()
    offset = re_.offset.value_ms(ec.step) if re_.offset is not None else 0
    window = re_.window.value_ms(ec.step) if re_.window is not None else 0

    def _series_rows(func, s_ts, s_vals, src_mn, cfg):
        from .format_value import fmt_value as _fmt_value
        from .vmhistogram import histogram_counts
        out_ts = cfg.out_timestamps()
        T = out_ts.size
        lo = np.searchsorted(s_ts, out_ts - cfg.lookback, side="right")
        hi = np.searchsorted(s_ts, out_ts, side="right")
        per_key: dict[bytes, np.ndarray] = {}
        for j in range(T):
            w = s_vals[lo[j]:hi[j]]
            if w.size == 0:
                continue
            if func == "count_values_over_time":
                vals, counts = np.unique(w, return_counts=True)
                items = [(_fmt_value(v).encode(), float(c))
                         for v, c in zip(vals, counts)]
            else:
                items = [(k.encode(), float(c))
                         for k, c in histogram_counts(w).items()]
            for key, c in items:
                row = per_key.get(key)
                if row is None:
                    row = per_key[key] = np.full(T, nan)
                row[j] = c
        label = dst_label if func == "count_values_over_time" else b"vmrange"
        group = src_mn.metric_group if keep_name else b""
        rows = []
        for key, row in sorted(per_key.items()):
            mn = MetricName(group,
                            [(k, v) for k, v in src_mn.labels
                             if k != label] + [(label, key)])
            mn.sort_labels()
            rows.append(Timeseries(mn, row))
        return rows

    out: list[Timeseries] = []
    if isinstance(re_.expr, MetricExpr) and not re_.needs_subquery():
        series, cfg, admission, _fi = _fetch_series_for_rollup(
            ec, func, re_, window, offset)
        with admission:
            for sd in series:
                out.extend(_series_rows(func, sd.timestamps, sd.values,
                                        sd.metric_name, cfg))
    else:
        rows, cfg = _subquery_series(ec, re_, window, offset)
        for s_ts, s_vals, src_mn in rows:
            out.extend(_series_rows(func, s_ts, s_vals, src_mn, cfg))
    return out


def suffix_child_bounds(ec: EvalConfig, new_start: int) -> tuple[int, bool]:
    """Grid start for evaluating the uncovered tail [new_start, ec.end] of
    a result-cache partial hit, plus whether the leading column must be
    dropped.  A single-column tail is evaluated on a TWO-column grid and
    the extra leading column discarded: a one-point grid flips rollups
    into instant-query maxPrevInterval semantics (rollup.go:719-728 —
    prevValue gated by step instead of the estimated scrape interval),
    which would diverge from the full-grid eval the cache stitches
    against.  The recomputed leading column is thrown away, never merged,
    so cached (final) columns are still never overwritten."""
    if new_start == ec.end and ec.end - ec.step >= ec.start:
        return new_start - ec.step, True
    return new_start, False


def trim_suffix_rows(rows: list[Timeseries]) -> list[Timeseries]:
    """Drop the extra leading column of a widened single-column tail eval
    (see suffix_child_bounds); zero-copy views."""
    return [Timeseries(ts.metric_name, ts.values[1:], raw=ts.raw)
            for ts in rows]


def _cache_rollup(ec, ckey, rows):
    if ckey is not None and not ec._partial[0] and not ec._partial_res[0]:
        import time as _t

        from .rollup_result_cache import GLOBAL as rcache
        rcache.put(ec, ckey, rows, int(_t.time() * 1000))
    return rows


def _drop_stale_nans(func: str, series):
    """Strip Prometheus staleness markers before rollup computation
    (reference eval.go:2081 dropStaleNaNs). default_rollup needs them for
    staleness detection; stale_samples_over_time counts them."""
    if func in ("default_rollup", "stale_samples_over_time"):
        return series
    from ..ops import decimal as dec_ops
    for sd in series:
        if not getattr(sd, "maybe_stale", True):
            continue  # every contributing block known stale-free (memo)
        stale = dec_ops.is_stale_nan(sd.values)
        if stale.any():
            keep = ~stale
            sd.timestamps = sd.timestamps[keep]
            sd.values = sd.values[keep]
    return series


def _blank_raw(raw: bytes) -> bytes:
    """marshal() of the name with metric_group blanked, as a suffix slice:
    escapes map 0x00 -> 0x02 0x03, so the first LITERAL 0x00 in a
    canonical raw name is the group/label separator."""
    i = raw.find(b"\x00")
    return raw[i:] if i >= 0 else b""


def _finish_rollup_names(metric_names, rows, keep_name: bool, raws=None
                         ) -> list[Timeseries]:
    """Build output rows; when the storage's canonical raw names are
    available they are attached (sliced for keep_name=False) so the rollup
    result cache never re-marshals 8k names per refresh."""
    out = []
    if raws is None:
        for mn_src, vals in zip(metric_names, rows):
            mn = MetricName(mn_src.metric_group if keep_name else b"",
                            list(mn_src.labels))
            out.append(Timeseries(mn, np.asarray(vals, dtype=np.float64)))
        return out
    for mn_src, vals, raw in zip(metric_names, rows, raws):
        mn = MetricName(mn_src.metric_group if keep_name else b"",
                        list(mn_src.labels))
        out.append(Timeseries(mn, np.asarray(vals, dtype=np.float64),
                              raw=raw if keep_name else _blank_raw(raw)))
    return out


def _finish_rollup(series, rows, keep_name: bool) -> list[Timeseries]:
    raws = [getattr(sd, "raw_name", None) for sd in series]
    if any(r is None for r in raws):
        raws = None
    return _finish_rollup_names((sd.metric_name for sd in series), rows,
                                keep_name, raws)


def _subquery_series(ec: EvalConfig, re_: RollupExpr, window: int,
                     offset: int):
    """Evaluate the inner expression of a subquery and return the NaN-
    stripped per-series samples plus the outer rollup config
    (eval.go:1006 evalRollupFuncWithSubquery)."""
    sub_step = (re_.step.value_ms(ec.step) if re_.step is not None
                else ec.step)
    if sub_step <= 0:
        raise QueryError("subquery step must be positive")
    lookback = window if window > 0 else ec.step
    start = ec.start - offset
    end = ec.end - offset
    # eval.go:1023: extend the inner range by window + step + the max
    # silence interval (5m) so prevValue / adjusted windows see the samples
    # just before the outer range, then step-align both ends as Prometheus
    # subqueries do (eval.go alignStartEnd). NOTE: the RAW window is used
    # here (0 when unspecified), not the effective lookback — using the
    # lookback shifts the inner grid by a full outer step, which visibly
    # shifts seeded rand() streams.
    sub_start = start - window - sub_step - 300_000
    sub_end = end + sub_step
    sub_start -= sub_start % sub_step
    if sub_end % sub_step:
        sub_end += sub_step - sub_end % sub_step
    inner_ec = ec.child(start=sub_start, end=sub_end, step=sub_step)
    inner = eval_expr(inner_ec, re_.expr)
    grid = inner_ec.timestamps()
    cfg = RollupConfig(start=start, end=end, step=ec.step, window=lookback)
    rows = []
    for ts in inner:
        ok = ~np.isnan(ts.values)
        s_ts = grid[ok]
        s_vals = ts.values[ok]
        if s_ts.size == 0:
            continue
        rows.append((s_ts, s_vals, ts.metric_name))
    return rows, cfg


def _rollup_subquery(ec: EvalConfig, func: str, re_: RollupExpr, window: int,
                     offset: int, args: tuple, keep_name: bool
                     ) -> list[Timeseries]:
    rows, cfg = _subquery_series(ec, re_, window, offset)
    out = []
    for s_ts, s_vals, src_mn in rows:
        c = cfg
        adj1 = adjusted_windows(func, window, ec.step, [s_ts])
        if adj1:
            c = RollupConfig(start=cfg.start, end=cfg.end, step=ec.step,
                             window=adj1[0])
        vals = rollup_series(func, s_ts, s_vals, c, args)
        mn = MetricName(src_mn.metric_group if keep_name else b"",
                        list(src_mn.labels))
        out.append(Timeseries(mn, vals))
    return out


# ---------------------------------------------------------------------------
# Aggregates
# ---------------------------------------------------------------------------

def _group_key(mn: MetricName, grouping: list[bytes], without: bool) -> bytes:
    if without:
        kept = [(k, v) for k, v in mn.labels if k not in grouping]
        return MetricName(b"", kept).marshal()
    kept = []
    group = b""
    for g in grouping:
        if g == b"__name__":
            group = mn.metric_group  # sum by (__name__) keeps the name
            continue
        v = mn.get_label(g)
        if v is not None:
            kept.append((g, v))
    return MetricName(group, sorted(kept)).marshal()


# (raw name, grouping signature) -> group key: a steady-state dashboard
# re-groups the SAME 10k series every refresh; the key is a pure function
# of the (immutable) raw name, so memoizing kills the per-refresh
# label-scan + marshal (bounded; cleared wholesale when full)
_GROUP_KEY_MEMO: dict = {}
_GROUP_KEY_MEMO_MAX = 1 << 18  # ~40MB worst case; clear-all on overflow


def _group_series(series: list[Timeseries], grouping: list[str],
                  without: bool):
    if not grouping and not without:
        # aggr over everything: the group key is the same empty name for
        # every series — skip the per-series marshal entirely
        if not series:
            return {}, {}  # match the loop below: no series, no groups
        key = MetricName(b"", []).marshal()
        return {key: list(series)}, {key: MetricName.unmarshal(key)}
    gb = [g.encode() for g in grouping]
    sig = (tuple(gb), without)
    memo = _GROUP_KEY_MEMO
    groups: dict[bytes, list[Timeseries]] = {}
    names: dict[bytes, MetricName] = {}
    for ts in series:
        raw = ts.raw
        if raw is not None:
            mkey = (raw, sig)
            key = memo.get(mkey)
            if key is None:
                key = _group_key(ts.metric_name, gb, without)
                if len(memo) >= _GROUP_KEY_MEMO_MAX:
                    memo.clear()
                memo[mkey] = key
        else:  # mutated/synthetic name: compute directly
            key = _group_key(ts.metric_name, gb, without)
        groups.setdefault(key, []).append(ts)
        if key not in names:
            names[key] = MetricName.unmarshal(key)
    return groups, names


_FUSED_AGGR_NAMES = ("sum", "count", "avg", "min", "max", "stddev",
                     "stdvar", "group")


def _tile_cache_key(ec: EvalConfig, expr, cfg: RollupConfig, fetch_info):
    """Query-level device tile-cache key: the tile content is fully
    determined by (selector, tenant, ACTUAL fetch bounds, dedup config,
    storage data version read before the fetch), so keying on those skips
    the per-series fingerprint hash on warm queries. cfg.start is included
    because tile timestamps are rebased to it. Falls back to content
    fingerprinting when the backing store exposes no data_version (e.g.
    cluster adapters)."""
    fetch_lo, fetch_hi, ver = fetch_info
    if ver is None:
        return None
    dedup = getattr(ec.storage, "dedup_interval_ms", 0)
    return ("tileq", str(expr), ec.tenant, fetch_lo, fetch_hi, cfg.start,
            dedup, ver)


def _device_aggr_shape(ae: AggrFuncExpr):
    """(phi, func, rollup-arg) of a device-fusable aggr(rollup(selector))
    expression, or None when the shape can't fuse (shared by the fused
    dispatch and the serving layer's residency-readiness probe)."""
    phi = None
    if ae.name in ("quantile", "median"):
        # quantile(phi, q) fuses when phi is a literal; median = 0.5
        if ae.name == "quantile":
            if len(ae.args) != 2 or not isinstance(ae.args[0], NumberExpr):
                return None
            phi = float(ae.args[0].value)
            arg = ae.args[1]
        else:
            if len(ae.args) != 1:
                return None
            phi = 0.5
            arg = ae.args[0]
    elif len(ae.args) != 1 or ae.name not in _FUSED_AGGR_NAMES:
        return None
    else:
        arg = ae.args[0]
    if isinstance(arg, FuncExpr):
        if len(arg.args) != 1 or arg.keep_metric_names:
            return None
        func, rarg = arg.name, arg.args[0]
    elif isinstance(arg, (MetricExpr, RollupExpr)):
        func, rarg = "default_rollup", arg
    else:
        return None
    if isinstance(rarg, MetricExpr):
        rarg = RollupExpr(expr=rarg)
    if not isinstance(rarg, RollupExpr) or \
            not isinstance(rarg.expr, MetricExpr) or rarg.expr.is_empty() or \
            rarg.needs_subquery() or rarg.at is not None:
        return None
    return phi, func, rarg


def _device_roll_keys(ec: EvalConfig, ae: AggrFuncExpr, func: str, rarg,
                      phi, window: int):
    """(roll_state_key, roll_tile_key) of the device-resident rolling
    window that serves this query shape, or (None, None) when the shape
    cannot roll (time-valued funcs read absolute grids; adjustable
    windows depend on per-fetch data)."""
    from ..ops.device_rollup import TIME_VALUED_FUNCS
    from .rollup_funcs import ADJUSTABLE_WINDOW_FUNCS
    if func in TIME_VALUED_FUNCS or func == "lifetime" or \
            (window <= 0 and (func in ADJUSTABLE_WINDOW_FUNCS
                              or func == "default_rollup")):
        return None, None
    roll_state_key = ("roll-aggr", str(rarg.expr), ec.tenant, func,
                      ae.name, phi, tuple(ae.grouping), ae.without,
                      ec.max_series)
    roll_tile_key = ("roll-tile", str(rarg.expr), ec.tenant, ec.max_series)
    return roll_state_key, roll_tile_key


def device_window_ready(ec: EvalConfig, e: Expr) -> bool:
    """True when the device plane holds a RESIDENT rolling window able to
    serve expression `e` O(new samples): the serving layer then runs the
    full-window eval (device rolling advance + [G, T] ring reuse) instead
    of the host ring-cache suffix path, so the refresh uploads only tail
    columns and the rollup never re-crosses the host boundary."""
    if ec.tpu is None or ec.disable_cache or ec.no_device_roll:
        return False
    from ..models.tile_cache import device_resident_enabled
    if not device_resident_enabled():
        return False
    if not isinstance(e, AggrFuncExpr):
        return False
    shape = _device_aggr_shape(e)
    if shape is None:
        return False
    phi, func, rarg = shape
    from ..ops import rollup_np
    from .cuda_engine import FUSED_AGGRS
    if func not in rollup_np.CORE_SUPPORTED or \
            (phi is None and e.name not in FUSED_AGGRS):
        return False
    if getattr(ec.storage, "data_version", None) is None or \
            getattr(ec.storage, "structural_version", None) is None:
        return False
    window = rarg.window.value_ms(ec.step) if rarg.window is not None else 0
    roll_state_key, _ = _device_roll_keys(ec, e, func, rarg, phi, window)
    if roll_state_key is None:
        return False
    wc = ec.tpu.window_cache()
    if wc.peek(roll_state_key) is None:
        # fleet members carry no per-shape wcache entry (adoption moved
        # the window into the batched plane); they are device-resident
        # all the same — and bypass the churn backoff below, because the
        # fleet advances them without per-shape rebuild churn
        from . import fleet as fleetmod
        return fleetmod.resident(ec.tpu, roll_state_key)
    # persistent-churn backoff: consecutive rolling declines mean this
    # shape keeps rebuilding FULL windows on device (each rebuild
    # re-registers the window, so entry existence alone would route the
    # next refresh right back).  Send it to the host suffix path (O(new
    # samples)) instead, retrying the device window every 16 refreshes
    # so shapes whose churn stopped come back to residency.
    st = wc.peek(("roll-declines",) + roll_state_key)
    if st is not None and st.get("streak", 0) >= 2:
        st["skipped"] = st.get("skipped", 0) + 1
        if st["skipped"] < 16:
            return False
        st["streak"] = 0
        st["skipped"] = 0
    return True


def _try_device_fused_aggr(ec: EvalConfig, ae: AggrFuncExpr
                           ) -> list[Timeseries] | None:
    """aggr by (...)(rollup(selector)) fused on device: rollup + segment
    aggregation in one kernel so only [G, T] crosses the link (the
    incremental-aggregation pushdown; None -> host path)."""
    if ec.tpu is None:
        return None
    shape = _device_aggr_shape(ae)
    if shape is None:
        return None
    phi, func, rarg = shape
    from ..models.tile_cache import count_window_hit, device_resident_enabled
    from ..ops import rollup_np
    from .cuda_engine import (FUSED_AGGRS, advance_rolling, aux_get,
                              aux_put, group_slots, groups_for,
                              register_window, run_fused_on_tiles,
                              run_quantile_on_tiles, try_aggr_rollup,
                              try_quantile_rollup)
    from .rollup_result_cache import RingBlock
    if func not in rollup_np.CORE_SUPPORTED or \
            (phi is None and ae.name not in FUSED_AGGRS):
        return None
    offset = rarg.offset.value_ms(ec.step) if rarg.offset is not None else 0
    window = rarg.window.value_ms(ec.step) if rarg.window is not None else 0

    def _emit(out, group_keys):
        rows = [Timeseries(MetricName.unmarshal(k),
                           np.asarray(out[g], dtype=np.float64))
                for g, k in enumerate(group_keys)]
        if ae.limit and len(rows) > ae.limit:
            rows = rows[:ae.limit]  # first-seen order (aggrPrepareSeries)
        rows.sort(key=lambda ts: ts.metric_name.marshal())
        return rows

    # warm shortcut: a query with the same shape against unchanged data
    # reuses the HBM-resident tile AND the cached group assignment — the
    # host fetch/decode/group pass is skipped entirely (only the [G, T]
    # aggregate crosses the link)
    aux_key = None
    ver = getattr(ec.storage, "data_version", None)
    if ec.no_device_roll:  # result-cache suffix eval: fresh tiles only
        ver = None         # (see EvalConfig.no_device_roll)
    if ec.disable_cache:  # nocache=1 / -search.disableCache bypasses every
        ver = None        # resident-tile reuse path (aux, rolling) too
    if not device_resident_enabled():
        ver = None  # VM_DEVICE_RESIDENT=0: full upload every query — the
        #             loud escape hatch and the residency equality oracle
    if ver is not None:
        # fleet shortcut: a matstream advance whose interval the fleet
        # prepass already served by the SHARED batched launch — the [G, T]
        # slice is sitting in the plane's result table (version- and
        # grid-matched), so this eval does zero storage reads and zero
        # launches.  The ver-gating above keeps every oracle path
        # (nocache / no_device_roll / VM_DEVICE_RESIDENT=0) off the fleet.
        rsk_fleet, _ = _device_roll_keys(ec, ae, func, rarg, phi, window)
        if rsk_fleet is not None:
            from . import fleet as fleetmod
            hit = fleetmod.take(ec, rsk_fleet)
            if hit is not None:
                count_window_hit()
                return _emit(hit[0], hit[1])
    if ver is not None:
        aux_key = ("fused-aux", str(rarg.expr), ec.tenant, ec.start, ec.end,
                   ec.step, window, offset, func, ae.name, phi,
                   tuple(ae.grouping), ae.without,
                   getattr(ec.storage, "dedup_interval_ms", 0),
                   ec.lookback_delta, ec.max_series, ver)
        aux = aux_get(ec.tpu, aux_key)
        if aux is not None:
            tile_key, cfg2, groups, group_keys, n_samples, qx = aux
            tiles = ec.tpu.cache().get(tile_key)
            if tiles is not None:
                ec.check_deadline()
                ec.count_samples(n_samples)
                with ec.tracer.new_child("tpu fused %s(%s) warm", ae.name,
                                         func) as qt:
                    if qx is not None:
                        out = run_quantile_on_tiles(ec.tpu, phi, func,
                                                    tiles, groups, cfg2)
                    else:
                        out = run_fused_on_tiles(ec.tpu, ae.name, func,
                                                 tiles, groups, cfg2)
                    qt.donef("resident tile, %d groups", len(group_keys))
                count_window_hit()
                return _emit(out, group_keys)

    # rolling shortcut: the same query SHAPE with advanced bounds and/or
    # append-only ingest. The resident tile absorbs only the new samples
    # (device scatter into reserved headroom, storage append-watermark
    # guarded) and answers with a traced grid shift — no host fetch, no
    # re-upload, no recompile. The tail-reuse role of the reference's
    # rollupResultCache (rollup_result_cache.go:283) done at tile level.
    lookback = window if window > 0 else (
        ec.lookback_delta if func == "default_rollup" else ec.step)
    roll_state_key = roll_tile_key = None
    if ver is not None and \
            getattr(ec.storage, "structural_version", None) is not None:
        roll_state_key, roll_tile_key = _device_roll_keys(
            ec, ae, func, rarg, phi, window)
    if roll_state_key is not None:
        wcache = ec.tpu.window_cache()
        stv = wcache.get(roll_state_key)
        if stv is not None:
            rt, groups, group_keys, qx, rb = stv
            start = ec.start - offset
            end = ec.end - offset
            fetch_lo = start - lookback - ec.lookback_delta
            filters = filters_from_metric_expr(rarg.expr, ec.storage)
            drop_stale = func not in ("default_rollup",
                                      "stale_samples_over_time")
            # one refresh of this tile at a time, from the append to the
            # ring's commit (RollingTile.lock)
            with rt.lock:
                qt = ec.tracer.new_child("tpu fused %s(%s) rolling", ae.name,
                                         func)
                if advance_rolling(ec.tpu, rt, ec.storage, filters, start,
                                   fetch_lo, end, ec.max_series, ec.tenant,
                                   drop_stale, tracer=qt):
                    ec.check_deadline()
                    ec.count_samples(rt.samples_in_range(fetch_lo))
                    cfg2 = RollupConfig(start=start, end=end, step=ec.step,
                                        window=lookback)
                    def kernel(kcfg):
                        # grid shift + fetch truncation are relative to the
                        # KERNEL grid's start (the tail sub-grid rebases both)
                        sh = kcfg.start - rt.base_ms
                        mt = fetch_lo - kcfg.start
                        if qx is not None:
                            return run_quantile_on_tiles(
                                ec.tpu, phi, func, rt.tiles, groups, kcfg, sh,
                                mt)
                        return run_fused_on_tiles(ec.tpu, ae.name, func,
                                                  rt.tiles, groups, kcfg, sh,
                                                  mt)

                    # Incremental grid: an advanced window re-uses the previous
                    # [G, T] result for every column at or before the previous
                    # end — append-only ingest (watermark-guarded) cannot touch
                    # windows ending there, so only the columns past the
                    # previous end run on device (the rollupResultCache
                    # tail-merge contract, rollup_result_cache.go:283, done at
                    # the [G, T] level by a RingBlock: the ring-cache entry
                    # machinery with fixed group rows.  Like the reference
                    # cache, re-used columns keep the scrape-interval estimates
                    # they were computed under — the constant-shape sliding
                    # advance only; anything else recomputes fresh.)
                    n_new = rb.try_advance(start, end, ec.step, lookback) \
                        if rb is not None else None
                    if n_new == 0:
                        rows_out = rb.commit(start, end, None)
                        qt.printf("pure shift: %d columns reused", rb.T)
                    elif n_new is not None:
                        qk = qt.new_child("fused tail kernel + D2H")
                        # the tail sub-grid must sit ON the eval grid's phase:
                        # the grid's last column is start + (T-1)*step, which
                        # is NOT `end` when (end - start) % step != 0 —
                        # anchoring the sub-grid at `end` would compute
                        # off-phase columns (a few-percent rate error that
                        # used to hide inside the documented drift bound).
                        # One extra leading column keeps start < end: a
                        # single-column sub-grid would hit the instant-query
                        # maxPrevInterval rule (rollup.go:719-728) and flip
                        # prev gating
                        grid_end = start + ((end - start) // ec.step) * ec.step
                        tail = kernel(RollupConfig(
                            start=grid_end - n_new * ec.step, end=grid_end,
                            step=ec.step, window=lookback))[:, 1:]
                        rows_out = rb.commit(start, end, tail)
                        qk.donef("[%d, %d] tail, %d columns reused",
                                 len(group_keys), n_new, rb.T - n_new)
                    else:
                        qk = qt.new_child("fused kernel + D2H")
                        out = kernel(cfg2)
                        qk.donef("[%d, %d] float64 out", len(group_keys),
                                 out.shape[1] if out.ndim > 1 else 0)
                        if rb is not None:
                            rb.reset(out, start, end, ec.step, lookback)
                            rows_out = rb.rows()
                        else:
                            rows_out = list(out)
                    qt.donef("advanced tile (%d appends), %d groups",
                             rt.appends, len(group_keys))
                    count_window_hit()
                    wcache.invalidate(("roll-declines",) + roll_state_key)
                    return _emit(rows_out, group_keys)
                qt.donef("not advanceable (%s); rebuilding",
                         ec.tpu.last_roll_decline)
            # feed the serving layer's churn backoff (device_window_ready)
            dk = ("roll-declines",) + roll_state_key
            dst = wcache.peek(dk) or {}
            wcache.put(dk, {"streak": dst.get("streak", 0) + 1,
                            "skipped": 0})

    series, cfg, admission, fetch_info = _fetch_series_for_rollup(
        ec, func, rarg, window, offset)
    adj = adjusted_windows(func, window, ec.step,
                           [sd.timestamps for sd in series])
    if adj:
        if all(a == adj[0] for a in adj):
            cfg = RollupConfig(start=cfg.start, end=cfg.end, step=cfg.step,
                               window=adj[0])
        else:
            with admission:
                pass
            ec.count_samples(-sum(s.timestamps.size for s in series))
            return None  # host path handles per-series windows
    n_fetched = sum(s.timestamps.size for s in series)

    def _decline():
        # the host path will re-fetch and re-count the same samples
        ec.count_samples(-n_fetched)
        return None

    with admission:
        if len(series) < ec.tpu.min_series:
            return _decline()  # host path re-fetches from warm caches
        gb = [g.encode() for g in ae.grouping]
        key_to_gid: dict[bytes, int] = {}
        gids = np.empty(len(series), dtype=np.int32)
        group_keys: list[bytes] = []
        for i, sd in enumerate(series):
            key = _group_key(sd.metric_name, gb, ae.without)
            gid = key_to_gid.get(key)
            if gid is None:
                gid = len(group_keys)
                key_to_gid[key] = gid
                group_keys.append(key)
            gids[i] = gid
        with ec.tracer.new_child("tpu fused %s(%s)", ae.name, func) as qt:
            tile_key = _tile_cache_key(ec, rarg.expr, cfg, fetch_info)
            qx = None
            slots = max_group = None
            if phi is not None:
                slots, max_group = group_slots(gids, len(group_keys))
                out = try_quantile_rollup(ec.tpu, phi, func, series, gids,
                                          len(group_keys), cfg, max_group,
                                          cache_key=tile_key)
            else:
                out = try_aggr_rollup(ec.tpu, ae.name, func, series, gids,
                                      len(group_keys), cfg,
                                      cache_key=tile_key)
            if out is None:
                qt.donef("fell back to host")
                return _decline()
            qt.donef("device path, %d series -> %d groups", len(series),
                     len(group_keys))
        groups = None
        if phi is not None:
            import torch
            qx = (torch.from_numpy(slots).to(ec.tpu.device), max_group)
        if aux_key is not None and tile_key is not None and \
                not ec._partial[0]:
            groups = groups_for(ec.tpu, gids, len(group_keys))
            aux_put(ec.tpu, aux_key,
                    (tile_key, cfg, groups, list(group_keys), n_fetched,
                     qx))
        if roll_state_key is not None and adj is None and \
                tile_key is not None and not ec._partial[0] and \
                not getattr(ec.storage, "dedup_interval_ms", 0) and \
                all(sd.raw_name is not None for sd in series):
            # the selector's RollingTile (a new one unless it was already
            # adopted from this cache entry) and the shape's 5-tuple
            # (rt, groups, group_keys, qx, RingBlock); nothing is filed
            # when the tile was evicted meanwhile
            register_window(ec.tpu, roll_state_key, roll_tile_key, gids,
                            group_keys, tile_key=tile_key, series=series,
                            cfg=cfg, fetch_info=fetch_info,
                            structural=ec.storage.structural_version,
                            groups=groups, qx=qx,
                            ring_block=RingBlock(out, cfg.start, cfg.end,
                                                 cfg.step, cfg.lookback))
    return _emit(out, group_keys)


_CHUNK_AGGRS = frozenset({"sum", "count", "avg", "min", "max"})


def _aggr_rollup_shape(arg):
    """aggr(func(selector[d])) shape shared by the host fused and chunked
    aggregation paths: returns (func, RollupExpr over a non-empty
    MetricExpr) or None when the argument is not a plain storage rollup."""
    if isinstance(arg, FuncExpr):
        if len(arg.args) != 1 or arg.keep_metric_names:
            return None
        func, rarg = arg.name, arg.args[0]
    elif isinstance(arg, (MetricExpr, RollupExpr)):
        func, rarg = "default_rollup", arg
    else:
        return None
    if isinstance(rarg, MetricExpr):
        rarg = RollupExpr(expr=rarg)
    if not isinstance(rarg, RollupExpr) or \
            not isinstance(rarg.expr, MetricExpr) or rarg.expr.is_empty() or \
            rarg.needs_subquery() or rarg.at is not None:
        return None
    return func, rarg


def _try_host_chunked_aggr(ec: EvalConfig, ae) -> list[Timeseries] | None:
    """Bounded-memory host incremental aggregation for BIG
    aggr by(...)(rollup(selector)) queries: chunked columnar fetch ->
    batched rollup per chunk -> running [G, T] accumulators, so the full
    padded (S, N) sample matrix never exists (the reference's
    tmp-blocks-spool + incremental-aggregation pairing,
    netstorage/tmp_blocks_file.go + eval.go:1055). Engages only when the
    estimated fetch would overflow half the rollup memory budget — the
    small/medium case keeps the cached full-fetch path. None = not
    applicable, use the normal path."""
    if ec.tpu is not None or ae.name not in _CHUNK_AGGRS:
        return None
    if len(ae.args) != 1 or ae.limit:
        return None
    shape = _aggr_rollup_shape(ae.args[0])
    if shape is None:
        return None
    func, rarg = shape
    from ..ops import rollup_np
    if not rollup_np.batch_supported(func, ()):
        return None
    st = ec.storage
    if getattr(st, "search_columns_chunked", None) is None or \
            getattr(st, "estimate_series", None) is None:
        return None
    offset = rarg.offset.value_ms(ec.step) if rarg.offset is not None else 0
    window = rarg.window.value_ms(ec.step) if rarg.window is not None else 0
    lookback = window if window > 0 else (
        ec.lookback_delta if func == "default_rollup" else ec.step)
    start = ec.start - offset
    end = ec.end - offset
    fetch_lo = start - lookback - ec.lookback_delta
    filters = filters_from_metric_expr(rarg.expr, ec.storage)
    from .limits import admit_rollup, rollup_memory_limiter
    try:
        n_series_est = st.estimate_series(filters, fetch_lo, end,
                                          tenant=ec.tenant)
    except Exception:
        return None
    est_samples = n_series_est * max((end - fetch_lo) // 15_000, 1)
    import os as _os
    budget = rollup_memory_limiter().max_size
    threshold = int(_os.environ.get("VM_CHUNKED_AGGR_MIN_BYTES",
                                    budget // 2))
    if est_samples * 16 <= threshold:
        return None  # fits comfortably: the cached full-fetch path wins

    T = ec.n_points
    cfg0 = RollupConfig(start=start, end=end, step=ec.step,
                        window=lookback)
    gb = [g.encode() for g in ae.grouping]
    # rollups that drop the metric name must group on the BLANKED name,
    # exactly like _finish_rollup_names(keep_name=False) before _group_key
    # on the normal path — `by (__name__)` output names must not depend
    # on which path ran
    keep_name = func == "default_rollup" or func in KEEP_METRIC_NAMES
    gidx: dict[bytes, int] = {}
    aggr = ae.name
    init = np.inf if aggr == "min" else -np.inf if aggr == "max" else 0.0
    # [G, T] running accumulators with geometric capacity growth (exact
    # regrowth per chunk would copy the full matrix O(n_chunks) times
    # for high-cardinality groupings)
    cap = 64
    acc_buf = np.full((cap, T), init)
    cnt_buf = np.zeros((cap, T))
    qt = ec.tracer.new_child(
        "host chunked %s(%s) %s: ~%d series", aggr, func, rarg.expr,
        n_series_est)
    n_samples = n_chunks = 0
    max_chunk = int(_os.environ.get(
        "VM_CHUNK_FETCH_SAMPLES", max(int(budget // 4 // 16), 1_000_000)))
    seen_series = 0
    try:
        for cols in st.search_columns_chunked(
                filters, fetch_lo, end, tenant=ec.tenant,
                max_chunk_samples=max_chunk):
            ec.check_deadline()
            if cols.n_series == 0:
                continue
            seen_series += cols.n_series
            if seen_series > ec.max_series:
                raise ResourceWarning(
                    f"query matches more than {ec.max_series} series")
            if func not in ("default_rollup", "stale_samples_over_time"):
                cols.drop_stale_nans()
            n_samples += cols.n_samples
            ec.count_samples(cols.n_samples)
            with admit_rollup(str(rarg.expr), cols.n_series, T,
                              ec.max_memory_per_query):
                cfg = cfg0
                adj = adjusted_windows(func, window, ec.step,
                                       cols.ts_list())
                per_series_cfg = None
                if adj:
                    if all(a == adj[0] for a in adj):
                        cfg = RollupConfig(start=start, end=end,
                                           step=ec.step, window=adj[0])
                    else:
                        per_series_cfg = [
                            RollupConfig(start=start, end=end,
                                         step=ec.step, window=a)
                            for a in adj]
                import time as _time
                t0r = _time.perf_counter()
                rows = None
                if per_series_cfg is None:
                    rows = rollup_np.rollup_batch_packed(
                        func, cols.ts, cols.vals, cols.counts, cfg, ())
                if rows is None:  # non-finite values / per-series windows
                    counts = cols.counts
                    rows = np.empty((cols.n_series, T))
                    for i in range(cols.n_series):
                        if i % 256 == 0:
                            ec.check_deadline()
                        c = (per_series_cfg[i]
                             if per_series_cfg is not None else cfg)
                        rows[i] = rollup_series(
                            func, cols.ts[i, :counts[i]],
                            cols.vals[i, :counts[i]], c, ())
                _rollup_phase_lap(t0r)
                rows = np.asarray(rows, dtype=np.float64)
                gids = np.empty(cols.n_series, np.int64)
                for i, mn in enumerate(cols.metric_names):
                    if gb or ae.without:
                        gmn = mn if keep_name else \
                            MetricName(b"", mn.labels)
                        key = _group_key(gmn, gb, ae.without)
                    else:
                        key = b""
                    g = gidx.get(key)
                    if g is None:
                        g = len(gidx)
                        gidx[key] = g
                    gids[i] = g
                while len(gidx) > cap:
                    cap *= 2
                if cap > acc_buf.shape[0]:
                    na = np.full((cap, T), init)
                    na[:acc_buf.shape[0]] = acc_buf
                    nc = np.zeros((cap, T))
                    nc[:cnt_buf.shape[0]] = cnt_buf
                    acc_buf, cnt_buf = na, nc
                # group-sorted reduceat: buffered row-block reductions
                # instead of ufunc.at's unbuffered per-scalar scatter
                # (10-30x on the (S_chunk, T) hot loop)
                finite = ~np.isnan(rows)
                order_g = np.argsort(gids, kind="stable")
                sg = gids[order_g]
                starts_i = np.flatnonzero(
                    np.concatenate([[True], sg[1:] != sg[:-1]]))
                uniq_g = sg[starts_i]
                rows_s = rows[order_g]
                finite_s = finite[order_g]
                if aggr in ("sum", "avg"):
                    acc_buf[uniq_g] += np.add.reduceat(
                        np.where(finite_s, rows_s, 0.0), starts_i, axis=0)
                elif aggr == "min":
                    acc_buf[uniq_g] = np.minimum(
                        acc_buf[uniq_g],
                        np.minimum.reduceat(
                            np.where(finite_s, rows_s, np.inf),
                            starts_i, axis=0))
                elif aggr == "max":
                    acc_buf[uniq_g] = np.maximum(
                        acc_buf[uniq_g],
                        np.maximum.reduceat(
                            np.where(finite_s, rows_s, -np.inf),
                            starts_i, axis=0))
                cnt_buf[uniq_g] += np.add.reduceat(
                    finite_s.astype(np.float64), starts_i, axis=0)
            n_chunks += 1
    except ResourceWarning as e:
        from .limits import QueryLimitError
        qt.donef("error: %s", e)
        raise QueryLimitError(
            f"{e}; either narrow the selector or raise "
            f"-search.maxUniqueTimeseries") from None
    except BaseException as e:
        qt.donef("error: %s", e)  # close the span on deadline/limit aborts
        raise
    qt.donef("%d chunks, %d samples, %d groups", n_chunks, n_samples,
             len(gidx))
    out = []
    nan = np.nan
    for key, g in gidx.items():
        have = cnt_buf[g] > 0
        if aggr == "count":
            vals = np.where(have, cnt_buf[g], nan)
        elif aggr == "avg":
            with np.errstate(invalid="ignore"):
                vals = np.where(have, acc_buf[g] / cnt_buf[g], nan)
        else:
            vals = np.where(have, acc_buf[g], nan)
        out.append(Timeseries(MetricName.unmarshal(key), vals))
    out.sort(key=lambda ts: ts.metric_name.marshal())
    return out


# (storage token, tenant, grouping, without, keep_name) -> (raw-name
# tuple, gids, group_keys, sorted emit order): a steady-state dashboard
# groups the SAME series set every refresh, so the per-series group-key
# scan collapses to one tuple comparison. Invalidated automatically when
# the fetched series set changes (new/vanished series); bounded clear-all.
_FUSED_GIDS_MEMO: dict = {}
_FUSED_GIDS_MEMO_MAX = 64
_EMPTY_NAME_KEY = MetricName(b"", []).marshal()


def _fused_group_ids(ec: EvalConfig, ae, cols, keep_name: bool,
                     sel_id: str):
    """Group assignment for the fused host aggregation: group keys,
    sorted output order and per-group row-index arrays
    (rows in input order, matching _group_series's vstack order),
    memoized on the fetched raw-name tuple (the hot steady-state case is
    an identical series set).  sel_id (the rollup argument's source
    text) keeps same-grouping panels over DIFFERENT selectors in
    separate slots — without it two such panels evict each other's memo
    every refresh."""
    gb = tuple(g.encode() for g in ae.grouping)
    token = getattr(ec.storage, "cache_token", None)
    sig = (token if token is not None else id(ec.storage), ec.tenant, gb,
           ae.without, keep_name, sel_id)
    raws_t = tuple(cols.raw_names)
    memo = _FUSED_GIDS_MEMO.get(sig)
    if memo is not None and memo[0] == raws_t:
        return memo[1], memo[2], memo[3]
    gbl = list(gb)
    key_to_gid: dict[bytes, int] = {}
    group_keys: list[bytes] = []
    rows_of: list[list[int]] = []
    for i, mn in enumerate(cols.metric_names):
        if i % 256 == 0:
            ec.check_deadline()
        if gbl or ae.without:
            # rollups that drop the metric name group on the BLANKED name,
            # exactly like _finish_rollup_names(keep_name=False) before
            # _group_key on the normal path
            gmn = mn if keep_name else MetricName(b"", mn.labels)
            key = _group_key(gmn, gbl, ae.without)
        else:
            key = _EMPTY_NAME_KEY
        gid = key_to_gid.get(key)
        if gid is None:
            gid = len(group_keys)
            key_to_gid[key] = gid
            group_keys.append(key)
            rows_of.append([])
        rows_of[gid].append(i)
    order = sorted(range(len(group_keys)), key=lambda g: group_keys[g])
    group_rows = [np.asarray(r, np.int64) for r in rows_of]
    if len(_FUSED_GIDS_MEMO) >= _FUSED_GIDS_MEMO_MAX:
        _FUSED_GIDS_MEMO.clear()
    # benign memo race: racing fills for one sig store equal values
    # (pure function of sig); a clear-vs-fill race just re-misses
    _FUSED_GIDS_MEMO[sig] = (raws_t, group_keys, order, group_rows)  # vmt: disable=VMT015
    return group_keys, order, group_rows


def _host_fused_aggr_compute(ec: EvalConfig, ae, func: str, rarg,
                             window: int, offset: int, keep_name: bool
                             ) -> list[Timeseries]:
    """One fused columnar pass: fetch -> packed rollup -> reduceat group
    aggregation -> (G, T) rows. No per-series Timeseries ever exists, so
    a tail suffix eval costs O(new samples) instead of O(S) Python."""
    from ..ops import rollup_np
    cols, cfg, admission, _ = _fetch_columns_for_rollup(
        ec, func, rarg, window, offset)
    T = ec.n_points
    aggr = ae.name
    qt = ec.tracer.new_child("host fused rollup %s(%s) (columns)", aggr,
                             func)
    try:
        with admission:
            if cols.n_series == 0:
                qt.donef("0 series")
                return []
            per_series_cfg = None
            adj = adjusted_windows(func, window, ec.step, cols.ts_list())
            if adj:
                if all(a == adj[0] for a in adj):
                    cfg = RollupConfig(start=cfg.start, end=cfg.end,
                                       step=cfg.step, window=adj[0])
                else:
                    per_series_cfg = [
                        RollupConfig(start=cfg.start, end=cfg.end,
                                     step=cfg.step, window=a)
                        for a in adj]
            import time as _time
            t0r = _time.perf_counter()
            rows = None
            if per_series_cfg is None:
                rows = rollup_np.rollup_batch_packed(
                    func, cols.ts, cols.vals, cols.counts, cfg, ())
            if rows is None:  # non-finite values / per-series windows
                counts = cols.counts
                rows = np.empty((cols.n_series, T))
                for i in range(cols.n_series):
                    if i % 256 == 0:
                        ec.check_deadline()
                    c = (per_series_cfg[i]
                         if per_series_cfg is not None else cfg)
                    rows[i] = rollup_series(func, cols.ts[i, :counts[i]],
                                            cols.vals[i, :counts[i]], c,
                                            ())
            rows = np.asarray(rows, dtype=np.float64)
            _rollup_phase_lap(t0r)
            group_keys, order, group_rows = _fused_group_ids(
                ec, ae, cols, keep_name, f"{func}|{rarg}")
            G = len(group_keys)
            # per-group reduction with the SAME aggregate kernels
            # _simple_aggr applies to its vstacked groups (rows gathered
            # in input order): bit-identical to the unfused path by
            # construction — reduceat would sum in a different order and
            # drift by ulps, breaking the served==cold rtol=0 invariant
            fn = SIMPLE[aggr]
            vals = np.empty((G, T))
            for g in range(G):
                vals[g] = fn(rows[group_rows[g]])
        qt.donef("%d series -> %d groups", cols.n_series, G)
    except BaseException as e:
        qt.donef("error: %s", e)  # close the span on deadline/limit aborts
        raise
    return [Timeseries(MetricName.unmarshal(group_keys[g]), vals[g],
                       raw=group_keys[g])
            for g in order]


def _try_host_fused_aggr(ec: EvalConfig, ae) -> list[Timeseries] | None:
    """aggr by (...)(rollup(selector)) fused on host: columnar fetch ->
    packed rollup -> reduceat group reduction, materializing only the
    (G, T) aggregated block — the host twin of the device fused path and
    the steady-state lever of ROADMAP item 2: a dashboard-suffix eval
    never rebuilds S per-series Timeseries or the S-row eval cache entry.
    The (G, T) result is cached in the rollup result cache keyed by the
    FULL aggregation (ring entries make the rolling merge in-place), so
    repeated/rolling evals of the same shape cost O(new samples).
    VM_HOST_FUSED_AGGR=0 restores the unfused path (equality oracle).
    None -> not applicable, use the normal path."""
    if ec.tpu is not None or ae.name not in _CHUNK_AGGRS:
        return None
    if len(ae.args) != 1 or ae.limit:
        return None
    import os as _os
    if _os.environ.get("VM_HOST_FUSED_AGGR", "1") == "0":
        return None
    shape = _aggr_rollup_shape(ae.args[0])
    if shape is None:
        return None
    func, rarg = shape
    from ..ops import rollup_np
    if not rollup_np.batch_supported(func, ()):
        return None
    if ec.storage is None or \
            getattr(ec.storage, "search_columns", None) is None:
        return None
    offset = rarg.offset.value_ms(ec.step) if rarg.offset is not None else 0
    window = rarg.window.value_ms(ec.step) if rarg.window is not None else 0
    keep_name = func == "default_rollup" or func in KEEP_METRIC_NAMES
    # mirror _rollup_from_storage's eval-cache gating (default_rollup's
    # lookback depends on ec state; negative offsets touch the volatile
    # now-edge)
    use_cache = (ec.n_points > 1 and func != "default_rollup"
                 and offset >= 0 and not ec.disable_cache
                 and not ec.no_eval_cache)
    if not use_cache:
        return _host_fused_aggr_compute(ec, ae, func, rarg, window, offset,
                                        keep_name)
    import time as _t

    from .rollup_result_cache import GLOBAL as rcache
    now_ms = int(_t.time() * 1000)
    ckey = (f"fusedaggr|{ae.name}|{','.join(ae.grouping)}|{ae.without}|"
            f"{func}|{rarg.expr}|{window}|{offset}|{keep_name}")
    cached, new_start = rcache.get(ec, ckey, now_ms)
    if cached is not None and new_start > ec.end:
        ec.tracer.printf("host fused aggr cache: full hit %s", ckey)
        return cached.rows()
    if cached is not None:
        ec.tracer.printf("host fused aggr cache: tail from %d", new_start)
        sub_start, trim = suffix_child_bounds(ec, new_start)
        sub = ec.child(start=sub_start)
        sub.no_eval_cache = True  # the suffix must not clobber ckey
        fresh = _host_fused_aggr_compute(sub, ae, func, rarg, window,
                                         offset, keep_name)
        if trim:
            fresh = trim_suffix_rows(fresh)
        rows = rcache.merge(cached, fresh, ec, new_start, now_ms=now_ms)
        if not ec._partial[0]:
            rcache.put(ec, ckey, rows, now_ms)
        return rows
    rows = _host_fused_aggr_compute(ec, ae, func, rarg, window, offset,
                                    keep_name)
    if not ec._partial[0]:
        rcache.put(ec, ckey, rows, now_ms)
    return rows


def _eval_aggr(ec: EvalConfig, ae: AggrFuncExpr) -> list[Timeseries]:
    name = ae.name

    fused = _try_device_fused_aggr(ec, ae)
    if fused is not None:
        return fused
    chunked = _try_host_chunked_aggr(ec, ae)
    if chunked is not None:
        return chunked
    hfused = _try_host_fused_aggr(ec, ae)
    if hfused is not None:
        return hfused

    # arg layouts
    if name in ("topk", "bottomk", "limitk", "outliersk") or \
            name.startswith(("topk_", "bottomk_")):
        remaining = None
        if len(ae.args) == 3 and isinstance(ae.args[2], StringExpr) and \
                name.startswith(("topk_", "bottomk_")):
            remaining = ae.args[2].value  # remaining-sum series tag
        elif len(ae.args) != 2:
            raise QueryError(f"{name} needs (k, q)")
        k = float(eval_expr(ec, ae.args[0])[0].values[0])
        if np.isnan(k) or k < 0:
            k = 0.0  # getIntK clamps (aggr.go:793)
        if name not in ("limitk", "outliersk") and not np.isinf(k):
            got = _try_device_topk(ec, ae, name, k, remaining)
            if got is not None:
                return got
        series = eval_expr(ec, ae.args[1])
        if np.isinf(k):
            k = float(len(series))
        return _eval_topk_family(ec, ae, name, k, series, remaining)
    if name == "quantile":
        phi = float(eval_expr(ec, ae.args[0])[0].values[0])
        series = eval_expr(ec, ae.args[1])
        return _simple_aggr(ec, ae, series,
                            lambda m: a_quantile(m, phi))
    if name == "quantiles":
        dst = ae.args[0]
        if not isinstance(dst, StringExpr):
            raise QueryError("quantiles needs a label name first")
        phis = [float(eval_expr(ec, a)[0].values[0]) for a in ae.args[1:-1]]
        series = eval_expr(ec, ae.args[-1])
        out = []
        for phi in phis:
            rows = _simple_aggr(ec, ae, series, lambda m: a_quantile(m, phi))
            for ts in rows:
                ts.metric_name.labels.append(
                    (dst.value.encode(), repr(phi).encode()))
                ts.metric_name.sort_labels()
                ts.raw = None  # memoized marshal is stale now
            out.extend(rows)
        return out
    if name == "count_values":
        dst = ae.args[0]
        if not isinstance(dst, StringExpr):
            raise QueryError("count_values needs a label name first")
        series = eval_expr(ec, ae.args[1])
        return _eval_count_values(ec, ae, dst.value, series)
    if name in ("share", "zscore"):
        series = eval_expr(ec, ae.args[0])
        return _eval_per_series(ec, ae, PER_SERIES[name], series)
    if name in ("mad", "iqr"):
        # plain aggregates union ALL their args (aggr.go getAggrTimeseries)
        series = [ts for a in ae.args for ts in eval_expr(ec, a)]
        def mad_fn(m):
            med = np.nanmedian(m, axis=0)
            return np.nanmedian(np.abs(m - med), axis=0)
        def iqr_fn(m):
            lo, hi = np.nanquantile(m, [0.25, 0.75], axis=0)
            return hi - lo
        with np.errstate(all="ignore"):
            return _simple_aggr(ec, ae, series,
                                mad_fn if name == "mad" else iqr_fn)
    if name == "outliers_mad":
        tol = float(eval_expr(ec, ae.args[0])[0].values[0])
        series = eval_expr(ec, ae.args[1])
        return _eval_outliers_mad(ec, ae, tol, series)
    if name == "outliers_iqr":
        series = eval_expr(ec, ae.args[0])
        return _eval_outliers_iqr(ec, ae, series)

    if name == "histogram":
        series = [ts for a in ae.args for ts in eval_expr(ec, a)]
        return _eval_histogram_aggr(ec, ae, series)

    if name == "any":
        # first series per group, ORIGINAL identity kept (aggr.go:156)
        series = [ts for a in ae.args for ts in eval_expr(ec, a)]
        groups, _ = _group_series(series, ae.grouping, ae.without)
        out = [rows[0] for rows in groups.values()]
        out.sort(key=lambda ts: ts.metric_name.marshal())
        return out

    series = [ts for a in ae.args for ts in eval_expr(ec, a)]
    fn = SIMPLE.get(name)
    if fn is None:
        raise QueryError(f"unknown aggregate {name!r}")
    return _simple_aggr(ec, ae, series, fn)


def _eval_histogram_aggr(ec, ae, series) -> list[Timeseries]:
    """histogram(q): per-step VM histogram over each group's values,
    emitted as CUMULATIVE le= buckets with zero-filled gaps — the
    reference converts through vmrangeBucketsToLE (aggr.go:256-285)."""
    from .transform_funcs import _vmrange_to_le
    from .vmhistogram import vmrange_for
    groups, names = _group_series(series, ae.grouping, ae.without)
    out = []
    for key, rows in groups.items():
        m = np.vstack([ts.values for ts in rows])
        per_range: dict[str, np.ndarray] = {}
        T = m.shape[1]
        for j in range(T):
            col = m[:, j]
            for v in col[~np.isnan(col)]:
                r = vmrange_for(float(v))
                if r is None:
                    continue
                row = per_range.get(r)
                if row is None:
                    row = per_range[r] = np.zeros(T)
                row[j] += 1.0
        base = names[key]
        raw = []
        for r, vals in sorted(per_range.items()):
            mn = MetricName(base.metric_group,
                            list(base.labels) + [(b"vmrange", r.encode())])
            mn.sort_labels()
            raw.append(Timeseries(mn, vals))
        out.extend(_vmrange_to_le(raw))
    out.sort(key=lambda ts: ts.metric_name.marshal())
    return out


def _simple_aggr(ec, ae, series, fn) -> list[Timeseries]:
    groups, names = _group_series(series, ae.grouping, ae.without)
    # `limit N` keeps the first N groups in INPUT order — groups past the
    # limit are skipped at grouping time (aggr.go:139 aggrPrepareSeries),
    # not after sorting.
    if ae.limit and len(groups) > ae.limit:
        groups = {k: groups[k] for k in list(groups)[:ae.limit]}
    out = []
    for key, rows in groups.items():
        m = np.vstack([ts.values for ts in rows])
        vals = fn(m)
        out.append(Timeseries(names[key], np.asarray(vals, dtype=np.float64)))
    out.sort(key=lambda ts: ts.metric_name.marshal())
    return out


def _eval_per_series(ec, ae, fn, series) -> list[Timeseries]:
    groups, _ = _group_series(series, ae.grouping, ae.without)
    out = []
    for key, rows in groups.items():
        m = np.vstack([ts.values for ts in rows])
        res = fn(m)
        for i, ts in enumerate(rows):
            out.append(Timeseries(MetricName(b"", list(ts.metric_name.labels)),
                                  res[i]))
    return out


def _remaining_sum_series(ec, ae, rows, selected_idx, tag_spec: str
                          ) -> Timeseries:
    """Sum of the NON-selected series, tagged tag[=value]
    (aggr.go:751 getRemainingSumTimeseries)."""
    if "=" in tag_spec:
        tag, _, value = tag_spec.partition("=")
    else:
        tag = value = tag_spec
    base = rows[0].metric_name
    gb = {g.encode() for g in ae.grouping}
    if ae.without:
        labels = [(kk, vv) for kk, vv in base.labels if kk not in gb]
    else:
        labels = [(kk, vv) for kk, vv in base.labels if kk in gb]
    labels = [(kk, vv) for kk, vv in labels if kk != tag.encode()]
    labels.append((tag.encode(), value.encode()))
    mn = MetricName(b"", sorted(labels))
    rest = [r for i, r in enumerate(rows) if i not in selected_idx]
    if not rest:
        return Timeseries(mn, np.full(ec.n_points, nan))
    m = np.vstack([r.values for r in rest])
    with np.errstate(all="ignore"):
        vals = np.where(np.isnan(m).all(axis=0), nan, np.nansum(m, axis=0))
    return Timeseries(mn, vals)


def _vm_name_hash(mn: MetricName) -> int:
    """aggr.go getHash: xxh64 (native.xxh64) over MetricGroup then raw
    key+value bytes of the sorted tags — NOT the length-prefixed marshal.
    Drives limitk()'s stable uniform series selection."""
    from .. import native
    parts = [mn.metric_group]
    for lk, lv in sorted(mn.labels):
        parts.append(lk)
        parts.append(lv)
    return native.xxh64(b"".join(parts))


def _try_device_topk(ec, ae, name: str, k: float,
                     remaining) -> list[Timeseries] | None:
    """topk/bottomk[_kind](k, rollup(selector)) fused on device: the
    [S, T] rollup stays in HBM, selection runs there, and only winner
    indices plus the k chosen rows cross the link (None -> host path)."""
    if ec.tpu is None or remaining is not None or ae.grouping or ae.without:
        return None
    arg = ae.args[1]
    if isinstance(arg, FuncExpr):
        if len(arg.args) != 1 or arg.keep_metric_names:
            return None
        func, rarg = arg.name, arg.args[0]
    elif isinstance(arg, (MetricExpr, RollupExpr)):
        func, rarg = "default_rollup", arg
    else:
        return None
    if isinstance(rarg, MetricExpr):
        rarg = RollupExpr(expr=rarg)
    if not isinstance(rarg, RollupExpr) or \
            not isinstance(rarg.expr, MetricExpr) or rarg.expr.is_empty() or \
            rarg.needs_subquery() or rarg.at is not None:
        return None
    from ..ops import rollup_np
    if func not in rollup_np.CORE_SUPPORTED:
        return None
    from .cuda_engine import try_topk_rollup
    keep_name = func in KEEP_METRIC_NAMES
    offset = rarg.offset.value_ms(ec.step) if rarg.offset is not None else 0
    window = rarg.window.value_ms(ec.step) if rarg.window is not None else 0
    series, cfg, admission, fetch_info = _fetch_series_for_rollup(
        ec, func, rarg, window, offset)
    adj = adjusted_windows(func, window, ec.step,
                           [sd.timestamps for sd in series])
    if adj:
        if not all(a == adj[0] for a in adj):
            # per-series windows: host path. Release the admission
            # reservation and roll back the sample count — the host
            # re-fetches and re-counts (same contract as
            # _try_device_fused_aggr's decline path)
            with admission:
                pass
            ec.count_samples(-sum(s.timestamps.size for s in series))
            return None
        cfg = RollupConfig(start=cfg.start, end=cfg.end, step=cfg.step,
                           window=adj[0])
    with admission:
        with ec.tracer.new_child("tpu fused %s(%s)", name, func) as qt:
            got = try_topk_rollup(
                ec.tpu, name, k, func, series, cfg,
                cache_key=_tile_cache_key(ec, rarg.expr, cfg, fetch_info))
            if got is None:
                qt.donef("fell back to host")
                ec.count_samples(-sum(s.timestamps.size for s in series))
                return None
            qt.donef("device selection, %d of %d series kept",
                     len(got), len(series))
    return _finish_rollup_names(
        (series[i].metric_name for i, _ in got),
        [vals for _, vals in got], keep_name)


def _eval_topk_family(ec, ae, name, k, series,
                      remaining: str | None = None) -> list[Timeseries]:
    groups, _ = _group_series(series, ae.grouping, ae.without)
    out = []
    bottom = name.startswith("bottomk")
    for key, rows in groups.items():
        m = np.vstack([ts.values for ts in rows])
        if name in ("topk", "bottomk"):
            mask = topk_mask_per_ts(m, int(k), bottom)
            for i, ts in enumerate(rows):
                vals = np.where(mask[i], ts.values, nan)
                if not np.isnan(vals).all():
                    out.append(Timeseries(ts.metric_name, vals))
        elif name == "limitk":
            if k <= 0:
                continue
            ranked = sorted(rows, key=lambda ts: _vm_name_hash(ts.metric_name))
            out.extend(ranked[:int(k)])
        elif name == "outliersk":
            med = np.nanmedian(m, axis=0)
            with np.errstate(all="ignore"):
                dev = np.nansum((m - med) ** 2, axis=1)
            # stable ascending sort, keep the LAST k: ties favor later
            # series (getRangeTopKTimeseries ordering)
            order = np.argsort(dev, kind="stable")
            kn = max(int(k), 0)
            for i in (order[-kn:] if kn else []):
                out.append(rows[i])
        else:
            kind = name.split("_", 1)[1]
            rank = series_rank_metric(kind, m)
            rank = np.where(np.isnan(rank), -np.inf if not bottom else np.inf,
                            rank)
            kn = max(int(k), 0)
            if bottom:
                # stable desc sort, keep last k: ties favor later series
                order = np.argsort(-rank, kind="stable")
            else:
                order = np.argsort(rank, kind="stable")
            sel = order[-kn:] if kn else []
            for i in sel:
                out.append(rows[i])
            if remaining is not None:
                out.append(_remaining_sum_series(ec, ae, rows, set(
                    int(i) for i in sel), remaining))
    return out


def _eval_count_values(ec, ae, dst_label, series) -> list[Timeseries]:
    # aggr.go:576: the dst label leaves `by` grouping / joins `without`
    # grouping, so the per-value output label always wins
    grouping = list(ae.grouping)
    if ae.without:
        if dst_label not in grouping:
            grouping.append(dst_label)
    else:
        grouping = [g for g in grouping if g != dst_label]
    groups, names = _group_series(series, grouping, ae.without)
    out = []
    for key, rows in groups.items():
        m = np.vstack([ts.values for ts in rows])
        uniq = np.unique(m[~np.isnan(m)])
        for u in uniq:
            cnt = np.nansum(np.where(m == u, 1.0, 0.0), axis=0)
            cnt = np.where(cnt > 0, cnt, nan)
            mn = MetricName(b"", list(names[key].labels))
            sval = repr(float(u))
            if float(u) == int(u) and abs(u) < 1e15:
                sval = str(int(u))
            mn.labels.append((dst_label.encode(), sval.encode()))
            mn.sort_labels()
            out.append(Timeseries(mn, cnt))
    return out


def _eval_outliers_mad(ec, ae, tolerance, series) -> list[Timeseries]:
    groups, _ = _group_series(series, ae.grouping, ae.without)
    out = []
    for key, rows in groups.items():
        m = np.vstack([ts.values for ts in rows])
        with np.errstate(all="ignore"):
            med = np.nanmedian(m, axis=0)
            mad = np.nanmedian(np.abs(m - med), axis=0)
        for i, ts in enumerate(rows):
            with np.errstate(all="ignore"):
                if np.any(np.abs(ts.values - med) > tolerance * mad):
                    out.append(ts)
    return out


def _eval_outliers_iqr(ec, ae, series) -> list[Timeseries]:
    groups, _ = _group_series(series, ae.grouping, ae.without)
    out = []
    for key, rows in groups.items():
        m = np.vstack([ts.values for ts in rows])
        with np.errstate(all="ignore"):
            q25, q75 = np.nanquantile(m, [0.25, 0.75], axis=0)
            iqr = q75 - q25
            lo, hi = q25 - 1.5 * iqr, q75 + 1.5 * iqr
        for i, ts in enumerate(rows):
            with np.errstate(all="ignore"):
                if np.any((ts.values < lo) | (ts.values > hi)):
                    out.append(ts)
    return out


# ---------------------------------------------------------------------------
# Binary ops
# ---------------------------------------------------------------------------

def _is_const_scalar(e: Expr) -> bool:
    """True scalars per PromQL: literals and scalar() — NOT time()/rand(),
    which are instant vectors (so comparisons keep THEIR values)."""
    if isinstance(e, (NumberExpr, DurationExpr)):
        return True
    if isinstance(e, FuncExpr) and e.name == "scalar":
        return True
    if isinstance(e, BinaryOpExpr) and e.op in ARITH_OPS:
        return _is_const_scalar(e.left) and _is_const_scalar(e.right)
    return False


def _is_union_expr(e: Expr) -> bool:
    return isinstance(e, FuncExpr) and e.name in ("union", "")


def _eval_binary(ec: EvalConfig, be: BinaryOpExpr) -> list[Timeseries]:
    if be.op in ("==", "!=") and \
            (_is_union_expr(be.left) or _is_union_expr(be.right)):
        # `q == (v1,...,vN)` value-list filtering (binary_op.go:58)
        left = eval_expr(ec, be.left)
        right = eval_expr(ec, be.right)
        if _is_union_expr(be.left):
            left, right = right, left
        if not left or not right:
            return [] if be.op == "==" else left
        vals_r = np.vstack([r.values for r in right])
        out = []
        for ts in left:
            contained = np.any(vals_r == ts.values[None, :], axis=0)
            keep = contained if be.op == "==" else ~contained
            out.append(Timeseries(ts.metric_name,
                                  np.where(keep, ts.values, nan)))
        return out

    l_scalar = _is_const_scalar(be.left)
    r_scalar = _is_const_scalar(be.right)
    left = eval_expr(ec, be.left)
    right = eval_expr(ec, be.right)

    if be.op in ARITH_OPS or be.op in CMP_OPS:
        if l_scalar and r_scalar:
            a, b = left[0].values, right[0].values
            if be.op in ARITH_OPS:
                return [new_series(ARITH_OPS[be.op](a, b))]
            m = CMP_OPS[be.op](a, b)
            if be.bool_modifier:
                return [new_series(m.astype(np.float64))]
            return [new_series(np.where(m, a, nan))]
        if r_scalar:
            b = right[0].values
            return _scalar_side(be, left, b, scalar_on_left=False)
        if l_scalar:
            a = left[0].values
            return _scalar_side(be, right, a, scalar_on_left=True)

    if be.op == "default" and r_scalar:
        b = right[0].values
        out = []
        for ts in left:
            vals = np.where(np.isnan(ts.values), b, ts.values)
            out.append(Timeseries(ts.metric_name, vals))
        return out

    return eval_binary_op(be.op, left, right, be.bool_modifier,
                          be.group_modifier, be.join_modifier,
                          be.keep_metric_names)


def _scalar_side(be: BinaryOpExpr, vec: list[Timeseries], s: np.ndarray,
                 scalar_on_left: bool) -> list[Timeseries]:
    out = []
    is_cmp = be.op in CMP_OPS
    for ts in vec:
        a, b = (s, ts.values) if scalar_on_left else (ts.values, s)
        if is_cmp:
            with np.errstate(all="ignore"):
                m = CMP_OPS[be.op](a, b)
            m = m & ~np.isnan(ts.values)
            if be.bool_modifier:
                vals = m.astype(np.float64)
                vals[np.isnan(ts.values)] = nan
            else:
                vals = np.where(m, ts.values, nan)
            # non-bool comparisons keep names on scalar compare; `bool`
            # resets the metric group (eval.go resetMetricGroupIfRequired)
            keep = not be.bool_modifier
        else:
            vals = ARITH_OPS[be.op](a, b)
            keep = be.keep_metric_names
        mn = MetricName(ts.metric_name.metric_group if keep else b"",
                        list(ts.metric_name.labels))
        out.append(Timeseries(mn, np.asarray(vals, dtype=np.float64)))
    return out
