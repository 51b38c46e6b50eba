"""Port parity for the host query functions against the reference's:
``query/rollup_funcs.py``, ``aggr_funcs.py``, ``transform_funcs.py``,
``binary_op.py``, ``gorand.py``, ``vmhistogram.py``, ``format_value.py``,
``limits.py`` and ``types.py``, and the cost and trace hooks under them
(``utils/costacc.py``, ``querytracer.py``, ``memory.py``).

Inputs are made from a seed with numpy: the ragged rows of
tests/test_torch_rollup_np.py (counter resets, stale NaNs) for the
rollups, a values matrix with NaN cells and columns for the aggregates,
and labelled ``Timeseries`` lists (gauges, integer-valued series,
cumulative ``le`` buckets, ``vmrange`` buckets, dotted names) built once
with each side's own ``MetricName``.  Every entry of each function table
is called on both sides with the same arguments; outputs are compared as
label sets (marshaled names, in order) and values bit for bit, and an
input a function refuses must raise the same error on both sides.  Every
comparison is exact: the port runs the reference's numpy code."""

import math

import numpy as np
import pytest

from test_torch_rollup_np import ARGS, GRIDS, ROWS
from victoriametrics_tpu.ops import rollup_np as ref_rnp
from victoriametrics_tpu.query import aggr_funcs as ref_aggr
from victoriametrics_tpu.query import binary_op as ref_bin
from victoriametrics_tpu.query import format_value as ref_fmt
from victoriametrics_tpu.query import gorand as ref_gorand
from victoriametrics_tpu.query import limits as ref_limits
from victoriametrics_tpu.query import rollup_funcs as ref_rf
from victoriametrics_tpu.query import transform_funcs as ref_tf
from victoriametrics_tpu.query import types as ref_types
from victoriametrics_tpu.query import vmhistogram as ref_vmh
from victoriametrics_tpu.query.metricsql import ast as ref_ast
from victoriametrics_tpu.storage.metric_name import MetricName as RefName
from victoriametrics_tpu.utils import costacc as ref_cost
from victoriametrics_tpu.utils import fasttime as ref_fasttime
from victoriametrics_tpu.utils import memory as ref_memory
from victoriametrics_tpu_torch.ops import rollup_np as rnp
from victoriametrics_tpu_torch.query import aggr_funcs, binary_op
from victoriametrics_tpu_torch.query import cuda_engine as ce
from victoriametrics_tpu_torch.query import format_value, gorand, limits
from victoriametrics_tpu_torch.query import rollup_funcs as rf
from victoriametrics_tpu_torch.query import transform_funcs as tf
from victoriametrics_tpu_torch.query import types, vmhistogram
from victoriametrics_tpu_torch.query.metricsql import ast as port_ast
from victoriametrics_tpu_torch.storage.metric_name import MetricName
from victoriametrics_tpu_torch.utils import costacc, fasttime, memory
from victoriametrics_tpu_torch.utils import querytracer

START, STEP = 1_753_700_400_000, 60_000
END = START + 11 * STEP
T = 12

PORT = dict(types=types, name=MetricName, ast=port_ast)
REF = dict(types=ref_types, name=RefName, ast=ref_ast)


def _bits_equal(got, want, what=""):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, what
    assert np.array_equal(got.view(np.int64), want.view(np.int64)), \
        f"{what}: {got} != {want}"


def _outcome(fn, *args):
    try:
        return fn(*args), None
    except Exception as e:  # noqa: BLE001 — the refusal is compared
        return None, f"{type(e).__name__}: {e}"


# -- labelled inputs ----------------------------------------------------------

def _label_specs():
    """name -> [(labels dict, values[T])], from one seed."""
    rng = np.random.default_rng(29)
    gauges = []
    for i in range(6):
        v = np.round(rng.normal(40, 25, T), 3)
        v[rng.random(T) < 0.2] = np.nan
        gauges.append(({"__name__": "m", "instance": f"i{i % 3}",
                        "job": "ab"[i // 3], "num": str(i * 1.5),
                        "env": "prod"}, v))
    counters = [({"__name__": "c", "instance": f"i{i}", "job": "a"},
                 np.cumsum(rng.integers(0, 9, T)).astype(np.float64))
                for i in range(3)]
    counters[1][1][7:] -= 20.0                     # a counter reset
    ints = [({"__name__": "bits", "instance": f"i{i}"},
             rng.integers(0, 64, T).astype(np.float64)) for i in range(3)]
    les = ("0.1", "0.5", "1", "5", "+Inf")
    hist = []
    for g in ("a", "b"):
        cum = np.cumsum(rng.integers(0, 20, (len(les), T)), axis=0)
        hist.extend(({"__name__": "h_bucket", "job": g, "le": le},
                     cum[k].astype(np.float64)) for k, le in enumerate(les))
    vmr = [({"__name__": "h", "vmrange": r}, rng.integers(
        0, 9, T).astype(np.float64)) for r in
        ("1.000e+00...1.136e+00", "1.136e+00...1.292e+00",
         "4.642e+00...5.275e+00")]
    dotted = [({"__name__": f"srv.host{i}.cpu.{k}"}, rng.normal(
        0, 1, T)) for i in range(2) for k in ("user", "sys")]
    one = [({}, np.full(T, 0.75))]
    return {"S": gauges, "C": counters, "I": ints, "H": hist, "V": vmr,
            "D": dotted, "ONE": one, "EMPTY": []}


SPECS = _label_specs()


class Ser:
    """A placeholder for a labelled input in an argument list."""

    def __init__(self, name):
        self.name = name

    def __repr__(self):
        return self.name


def _series(side, name):
    ty, mn = side["types"], side["name"]
    return [ty.Timeseries(mn.from_dict(d), np.array(v, dtype=np.float64))
            for d, v in SPECS[name]]


def _args(side, spec):
    return [_series(side, a.name) if isinstance(a, Ser) else a
            for a in spec]


def _same_series(got, want, what=""):
    assert isinstance(got, list) and isinstance(want, list), what
    assert [t.metric_name.marshal() for t in got] == \
        [t.metric_name.marshal() for t in want], what
    for i, (g, w) in enumerate(zip(got, want)):
        _bits_equal(g.values, w.values, f"{what} row {i}")


def _ec(side, start=START, end=END):
    return side["types"].EvalConfig(start=start, end=end, step=STEP)


# -- rollup_funcs -------------------------------------------------------------

def _rollup_cases():
    out = []
    for func in sorted(ref_rf.ROLLUP_FUNC_NAMES):
        if func in ref_rf.MULTI_FUNCS:
            tags = [t for t, _ in ref_rf.MULTI_FUNCS[func]]
            out.extend((func, (t,)) for t in tags)
        elif func in ("holt_winters", "double_exponential_smoothing"):
            out.append((func, (0.5, 0.3)))
        else:
            out.append((func, ARGS.get(func, ())))
    return out


ROLLUP_CASES = _rollup_cases()


def test_rollup_tables_equal_the_reference():
    assert rf.ROLLUP_FUNC_NAMES == ref_rf.ROLLUP_FUNC_NAMES
    assert rf.ORACLE_FUNCS == ref_rf.ORACLE_FUNCS
    assert set(rf.GENERIC_FUNCS) == set(ref_rf.GENERIC_FUNCS)
    assert {k: v[1:] for k, v in rf.GENERIC_FUNCS.items()} == \
        {k: v[1:] for k, v in ref_rf.GENERIC_FUNCS.items()}
    assert rf.MULTI_FUNCS == ref_rf.MULTI_FUNCS
    assert rf.KEEP_METRIC_NAMES == ref_rf.KEEP_METRIC_NAMES
    assert rf.PRE_ROLLUP_FUNCS == ref_rf.PRE_ROLLUP_FUNCS
    # the device engine declines the same adjustable windows
    assert rf.ADJUSTABLE_WINDOW_FUNCS == ref_rf.ADJUSTABLE_WINDOW_FUNCS
    assert ce.ADJUSTABLE_WINDOW_FUNCS is rf.ADJUSTABLE_WINDOW_FUNCS


@pytest.mark.parametrize("func,args", ROLLUP_CASES,
                         ids=[f"{f}-{'-'.join(map(str, a))}"
                              for f, a in ROLLUP_CASES])
def test_rollup_series_equals_the_reference(func, args):
    for grid, g in GRIDS.items():
        pc, rc = rnp.RollupConfig(*g), ref_rnp.RollupConfig(*g)
        for i, (ts, v) in enumerate(ROWS):
            got, gerr = _outcome(rf.rollup_series, func, ts, v, pc, args)
            want, werr = _outcome(ref_rf.rollup_series, func, ts, v, rc,
                                  args)
            assert gerr == werr, (grid, i)
            if want is not None:
                _bits_equal(got, want, f"{func} {grid} row {i}")


def test_adjusted_windows_equal_the_reference():
    tss = [ts for ts, _ in ROWS]
    for func in ("rate", "deriv", "sum_over_time", "rollup_candlestick"):
        for window in (0, 300_000):
            for rows in (tss, tss * 7):      # the per-series and batched
                assert rf.adjusted_windows(func, window, STEP, rows) == \
                    ref_rf.adjusted_windows(func, window, STEP, rows)
    assert len(tss * 7) >= 64


# -- aggr_funcs ---------------------------------------------------------------

def _matrix():
    rng = np.random.default_rng(31)
    m = np.round(rng.normal(10, 30, (9, T)), 2)
    m[rng.random((9, T)) < 0.25] = np.nan
    m[:, 3] = np.nan                    # an all-NaN column
    m[2, 5] = m[4, 5] = m[6, 5]         # ties
    m[1, 6] = -0.0
    m[7, 6] = 0.0
    return m


M = _matrix()


def test_aggr_tables_equal_the_reference():
    assert set(aggr_funcs.SIMPLE) == set(ref_aggr.SIMPLE)
    assert set(aggr_funcs.PER_SERIES) == set(ref_aggr.PER_SERIES)


@pytest.mark.parametrize("name", sorted(ref_aggr.SIMPLE) +
                         sorted(ref_aggr.PER_SERIES))
def test_aggregate_equals_the_reference(name):
    table = "SIMPLE" if name in ref_aggr.SIMPLE else "PER_SERIES"
    for m in (M, np.abs(M) + 1.0, M[:1], np.full((3, T), np.nan)):
        with np.errstate(all="ignore"):
            got = getattr(aggr_funcs, table)[name](m.copy())
            want = getattr(ref_aggr, table)[name](m.copy())
        _bits_equal(got, want, name)


@pytest.mark.parametrize("phi", [-0.5, 0.0, 0.25, 0.5, 0.9, 1.0, 1.5,
                                 float("nan")])
def test_quantile_equals_the_reference(phi):
    _bits_equal(aggr_funcs.a_quantile(M, phi), ref_aggr.a_quantile(M, phi))


@pytest.mark.parametrize("kind", ["avg", "min", "max", "median", "last"])
def test_series_rank_metric_equals_the_reference(kind):
    with np.errstate(all="ignore"):
        _bits_equal(aggr_funcs.series_rank_metric(kind, M),
                    ref_aggr.series_rank_metric(kind, M))


@pytest.mark.parametrize("bottom", [False, True])
@pytest.mark.parametrize("k", [0, 1, 3, 9, 20])
def test_topk_mask_equals_the_reference(k, bottom):
    got = aggr_funcs.topk_mask_per_ts(M, k, bottom)
    assert np.array_equal(got, ref_aggr.topk_mask_per_ts(M, k, bottom))


# -- transform_funcs ----------------------------------------------------------

S, C, I, H, V, D, ONE, EMPTY = (Ser(n) for n in
                                ("S", "C", "I", "H", "V", "D", "ONE",
                                 "EMPTY"))
TRANSFORM_ARGS = {
    "round": [S, 0.1], "clamp": [S, 10.0, 60.0], "clamp_min": [S, 30.0],
    "clamp_max": [S, 30.0], "time": [], "now": [], "step": [], "start": [],
    "end": [], "pi": [], "e": [], "rand": [1.0], "rand_normal": [7.0],
    "rand_exponential": [3.0], "scalar": [ONE], "vector": [S],
    "union": [S, C], "sort_by_label": [S, "instance"],
    "sort_by_label_desc": [S, "num"], "sort_by_label_numeric": [S, "num"],
    "sort_by_label_numeric_desc": [S, "num"], "limit_offset": [2.0, 1.0, S],
    "absent": [EMPTY], "range_quantile": [0.5, S],
    "remove_resets": [C], "label_set": [S, "x", "y", "job", "z"],
    "label_del": [S, "job", "env"], "label_keep": [S, "instance"],
    "label_copy": [S, "instance", "dst", "job", "instance"],
    "label_move": [S, "instance", "dst"],
    "label_replace": [S, "dst", "$1-x", "instance", "i(.*)"],
    "label_join": [S, "dst", "-", "instance", "job"],
    "label_value": [S, "num"], "label_transform": [S, "instance", "i",
                                                    "host"],
    "label_map": [S, "instance", "i0", "zero", "i1", "one"],
    "label_lowercase": [S, "job"], "label_uppercase": [S, "job"],
    "label_match": [S, "instance", "i[01]"],
    "label_mismatch": [S, "instance", "i[01]"],
    "labels_equal": [S, "instance", "job"],
    "label_graphite_group": [D, 0.0, 3.0],
    "histogram_quantile": [0.9, H], "histogram_avg": [H],
    "prometheus_buckets": [V], "buckets_limit": [3.0, H],
    "histogram_share": [0.5, H], "histogram_fraction": [0.1, 1.0, H],
    "histogram_stddev": [H], "histogram_stdvar": [H],
    "histogram_quantiles": ["phi", 0.5, 0.9, H],
    "smooth_exponential": [S, 0.5], "bitmap_and": [I, 6.0],
    "bitmap_or": [I, 6.0], "bitmap_xor": [I, 6.0],
    "range_trim_zscore": [1.0, S], "range_trim_outliers": [1.0, S],
    "range_trim_spikes": [0.2, S], "timezone_offset": ["Europe/Berlin"],
    "interpolate": [S], "keep_last_value": [S], "keep_next_value": [S],
}


def _transform_cases():
    out = []
    for name in sorted(ref_tf.TRANSFORM_FUNCS):
        out.append((name, TRANSFORM_ARGS.get(name, [S])))
    # second forms: the date funcs on the grid, vmrange buckets, the
    # histogram's bounds label, refusals
    out += [("hour", []), ("day_of_week", []), ("histogram_quantile",
                                                [0.5, V]),
            ("histogram_quantile", [0.5, H, "bounds"]),
            ("histogram_share", [0.5, H, "bounds"]),
            ("vector", [2.5]), ("scalar", [S]), ("absent", [S]),
            ("round", [S, ONE]), ("timezone_offset", ["No/Such_Zone"]),
            ("label_set", [S, 1.0, "y"]), ("labels_equal", [S, "env", "env"])]
    # the inverse trigonometry inside its domain
    out += [(name, [D]) for name in ("acos", "asin", "atanh")]
    return out


TRANSFORM_CASES = _transform_cases()


def test_transform_table_equals_the_reference():
    assert set(tf.TRANSFORM_FUNCS) == set(ref_tf.TRANSFORM_FUNCS)
    assert len(tf.TRANSFORM_FUNCS) == 113


@pytest.mark.parametrize("name,spec", TRANSFORM_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(TRANSFORM_CASES)])
def test_transform_equals_the_reference(name, spec, monkeypatch):
    now = 1_753_700_123.0
    monkeypatch.setattr(fasttime, "unix_seconds", lambda: now)
    monkeypatch.setattr(ref_fasttime, "unix_seconds", lambda: now)
    got, gerr = _outcome(tf.TRANSFORM_FUNCS[name], _ec(PORT),
                         _args(PORT, spec))
    want, werr = _outcome(ref_tf.TRANSFORM_FUNCS[name], _ec(REF),
                          _args(REF, spec))
    assert gerr == werr
    if want is not None:
        _same_series(got, want, name)


# -- binary_op ----------------------------------------------------------------

def _binary_inputs(side):
    mk = side["name"].from_dict
    ty = side["types"]
    rng = np.random.default_rng(37)
    lv = np.round(rng.normal(5, 4, (6, T)), 2)
    lv[rng.random((6, T)) < 0.2] = np.nan
    rv = np.round(rng.normal(5, 4, (3, T)), 2)
    rv[0, :4] = np.nan
    rv[2, 2] = 0.0
    left = [ty.Timeseries(mk({"__name__": "l", "instance": f"i{i % 3}",
                              "job": "ab"[i // 3]}), lv[i].copy())
            for i in range(6)]
    right = [ty.Timeseries(mk({"__name__": "r", "instance": f"i{i}",
                               "job": "a", "tier": f"t{i}"}), rv[i].copy())
             for i in range(3)]
    same = [ty.Timeseries(mk({"__name__": "r", "instance": f"i{i % 3}",
                              "job": "ab"[i // 3]}), rv[i % 3].copy())
            for i in range(6)]
    return {"left": left, "left1": left[:3], "right": right, "same": same}


MODS = {
    "none": (("", []), ("", [])),
    "on": (("on", ["instance"]), ("", [])),
    "ignoring": (("ignoring", ["job", "tier"]), ("", [])),
    "on_left": (("on", ["instance"]), ("group_left", ["tier"])),
    "on_right": (("on", ["instance"]), ("group_right", [])),
}
#: (modifier, (left, right)): one to one on all labels, on one label and
#: ignoring two; many to one both ways; no match; many to many (refused)
JOINS = [("none", ("left", "same")), ("on", ("left1", "right")),
         ("ignoring", ("right", "left1")), ("on_left", ("left", "right")),
         ("on_right", ("right", "left")), ("none", ("left", "right")),
         ("on", ("left", "right"))]


def _binary_cases():
    out = []
    for op in sorted(ref_bin.ARITH_OPS) + sorted(ref_bin.CMP_OPS) + \
            sorted(ref_bin.SET_OPS):
        for mod, pair in JOINS:
            for flag in ((False, True) if op in ref_bin.CMP_OPS
                         else (False,)):
                out.append((op, mod, pair, flag))
    return out


BINARY_CASES = _binary_cases()


def test_binary_tables_equal_the_reference():
    assert set(binary_op.ARITH_OPS) == set(ref_bin.ARITH_OPS)
    assert set(binary_op.CMP_OPS) == set(ref_bin.CMP_OPS)
    assert binary_op.SET_OPS == ref_bin.SET_OPS


@pytest.mark.parametrize("op,mod,pair,bool_mod", BINARY_CASES,
                         ids=[f"{o}-{m}-{p[0]}-{p[1]}-{int(b)}"
                              for o, m, p, b in BINARY_CASES])
def test_binary_op_equals_the_reference(op, mod, pair, bool_mod):
    outs = []
    for side, module in ((PORT, binary_op), (REF, ref_bin)):
        ins = _binary_inputs(side)
        (gop, gargs), (jop, jargs) = MODS[mod]
        me = side["ast"].ModifierExpr
        outs.append(_outcome(
            module.eval_binary_op, op, ins[pair[0]], ins[pair[1]], bool_mod,
            me(gop, list(gargs)), me(jop, list(jargs)), False))
    (got, gerr), (want, werr) = outs
    assert gerr == werr
    if want is not None:
        _same_series(got, want, f"{op} {mod} {pair}")


def test_merge_values_non_overlapping_equals_the_reference():
    rng = np.random.default_rng(41)
    for _ in range(20):
        a, b = rng.normal(size=(2, T))
        a[rng.random(T) < 0.5] = np.nan
        b[rng.random(T) < 0.5] = np.nan
        pa, ra = a.copy(), a.copy()
        assert binary_op.merge_values_non_overlapping(pa, b.copy()) == \
            ref_bin.merge_values_non_overlapping(ra, b.copy())
        _bits_equal(pa, ra)


# -- gorand, vmhistogram, format_value ----------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 42, -5, 2**31 - 1, 2**40 + 3])
def test_gorand_sequences_equal_the_reference(seed):
    for draw in ("int63", "uint32", "float64", "norm_float64",
                 "exp_float64"):
        p, r = gorand.GoRand(seed), ref_gorand.GoRand(seed)
        got = [getattr(p, draw)() for _ in range(300)]
        want = [getattr(r, draw)() for _ in range(300)]
        assert got == want, draw


def test_gorand_matches_go():
    """Go's rand.New(rand.NewSource(1)): Int63() and Float64()."""
    assert gorand.GoRand(1).int63() == 5577006791947779410
    assert gorand.GoRand(1).float64() == 0.6046602879796196


def test_gorand_cooked_table_rebuilds():
    assert np.array_equal(gorand._generate_cooked(),
                          np.array(gorand._cooked_table(), dtype=np.uint64))


def _histogram_values():
    rng = np.random.default_rng(43)
    vals = list(10.0 ** rng.uniform(-11, 19, 400))
    vals += [0.0, -1.0, float("nan"), float("inf"), 1e-9, 1e18, 1.0, 10.0,
             1e-10, 5e18, 1.1364636663857248]
    return vals


def test_vmhistogram_equals_the_reference():
    assert vmhistogram._bucket_ranges() == ref_vmh._bucket_ranges()
    assert (vmhistogram.LOWER_RANGE, vmhistogram.UPPER_RANGE) == \
        (ref_vmh.LOWER_RANGE, ref_vmh.UPPER_RANGE)
    vals = _histogram_values()
    for v in vals:
        assert vmhistogram.vmrange_for(v) == ref_vmh.vmrange_for(v), v
    assert vmhistogram.histogram_counts(vals) == \
        ref_vmh.histogram_counts(vals)


def test_format_value_equals_the_reference():
    rng = np.random.default_rng(47)
    vals = list(rng.normal(0, 1e6, 200)) + [
        0.0, -0.0, 1.0, 1e15, 1e15 + 1, 1e16, 123.0, 0.1, 1 / 3,
        float("nan"), float("inf"), float("-inf"), np.float64(2.5),
        np.int64(7), 5e-324]
    for v in vals:
        assert format_value.fmt_value(v) == ref_fmt.fmt_value(v), v


# -- limits, types, the cost and trace hooks ----------------------------------

def test_limits_equal_the_reference(monkeypatch):
    for mod in (memory, ref_memory):
        monkeypatch.setattr(mod, "_allowed_bytes_override", 400_000)
    for mod in (limits, ref_limits):
        monkeypatch.setattr(mod, "_rollup_limiter", None)
    for n, pts in ((1, 1), (10, 1000), (100, 500), (3, 2000)):
        assert limits.estimate_rollup_memory(n, pts) == \
            ref_limits.estimate_rollup_memory(n, pts)
    seq = [(10, 100, 0), (10, 100, 20_000), (20, 500, 0), (1, 1, 0),
           (30, 1000, 0)]
    held = {id(limits): [], id(ref_limits): []}
    results = {}
    for mod in (limits, ref_limits):
        out = []
        for n, pts, cap in seq:
            adm, err = _outcome(mod.admit_rollup, "q", n, pts, cap)
            out.append(err)
            if adm is not None:
                held[id(mod)].append(adm)
        out.append(mod.rollup_memory_limiter().usage)
        for adm in held[id(mod)]:
            with adm:
                pass
        out.append(mod.rollup_memory_limiter().usage)
        results[mod.__name__.split(".")[0]] = out
    assert results["victoriametrics_tpu_torch"] == \
        results["victoriametrics_tpu"]
    assert any(results["victoriametrics_tpu"][:5])   # some refusals
    lim = limits.MemoryLimiter(10)
    assert lim.get(6) and not lim.get(5) and lim.get(4)
    with pytest.raises(ValueError, match="releasing more"):
        lim.put(11)
    assert issubclass(limits.QueryLimitError, ValueError)


def test_eval_config_equals_the_reference():
    for side in (PORT, REF):
        ec = _ec(side)
        side["ec"] = ec
        side["child"] = ec.child(start=START + STEP)
        side["ec"].count_samples(5)
        side["child"].count_samples(7)
    for key in ("ec", "child"):
        p, r = PORT[key], REF[key]
        _bits_equal(p.timestamps(), r.timestamps())
        assert p.n_points == r.n_points and \
            p.samples_scanned == r.samples_scanned == 12
        assert p.cost.samples == r.cost.samples == 12
    assert PORT["ec"].cost is PORT["child"].cost
    for kw in (dict(step=0), dict(end=START - 1),
               dict(max_points_per_series=3)):
        args = {**dict(start=START, end=END, step=STEP), **kw}
        err = _outcome(lambda: types.EvalConfig(**args))[1]
        assert err is not None and \
            err == _outcome(lambda: ref_types.EvalConfig(**args))[1]
    ecs = [side["types"].EvalConfig(start=START, end=END, step=STEP,
                                    max_samples_per_query=10)
           for side in (PORT, REF)]
    errs = [_outcome(ec.count_samples, 11)[1] for ec in ecs]
    assert errs[0] == errs[1] and "maxSamplesPerQuery" in errs[0]
    for side, mod in ((PORT, types), (REF, ref_types)):
        ts = mod.new_series(np.arange(T), b"g", [(b"a", b"1")])
        side["copied"] = ts.copy_shallow_labels()
        side["const"] = mod.const_series(_ec(side), 2.5)
    assert PORT["copied"].metric_name.marshal() == \
        REF["copied"].metric_name.marshal()
    _bits_equal(PORT["const"].values, REF["const"].values)


def test_cost_hooks_behave_as_the_reference():
    """No tracker: every storage hook is a no-op.  With one: the same
    sums on both sides (the wall laps and byte counts; the thread-CPU
    laps are the thread's own)."""
    for mod in (costacc, ref_cost):
        mod.set_current(None)
        mod.restamp()
        mod.lap("fetch:index_search", 0.5)
        mod.add_part_bytes(10)
        assert mod.current() is None
    trackers = []
    for mod in (costacc, ref_cost):
        tr = mod.CostTracker()
        prev = mod.set_current(tr)
        mod.restamp()
        mod.lap("fetch:index_search", 0.25)
        mod.lap("fetch:index_search", 0.5)
        mod.add_part_bytes(100)
        mod.add_samples(7)
        mod.add_rpc_bytes(3)
        mod.add_device(up=5, down=6)
        tr.merge_remote({"samples": 2, "partBytes": 1, "wallMs": {"x": 1}})
        tr.merge_remote(None)
        mod.set_current(prev)
        s = tr.summary()
        s.pop("cpuMs")
        s.pop("cpuMsByPhase")
        trackers.append(s)
    assert trackers[0] == trackers[1]
    assert trackers[0]["wallMsByPhase"]["fetch:index_search"] == 750.0


def test_tracer_and_memory_work():
    tr = querytracer.Tracer("query %s", "q")
    with tr.new_child("fetch") as ch:
        ch.printf("%d series", 3)
    tr.donef()
    assert tr.enabled
    assert tr.to_dict()["children"][0]["message"].startswith("fetch")
    assert querytracer.current() is querytracer.NOP
    assert not querytracer.NOP.enabled
    prev = querytracer.set_current(tr)
    assert querytracer.current() is tr
    querytracer.set_current(prev)
    assert memory.allowed() > 0 and memory.available_cpus() >= 1
    assert math.isfinite(memory.remaining())
