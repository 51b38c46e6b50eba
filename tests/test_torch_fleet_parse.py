"""The fleet's analysis of a standing query's text
(victoriametrics_tpu_torch/query/fleet.py FleetPlane._analyze) against the
reference's: its ``_device_aggr_shape`` and ``_device_roll_keys`` on a
reference ``EvalConfig`` with the serving front end's defaults (lookback
delta 5 m, 1,000,000 series), composed as the reference's fleet composes
them, and the reference plane's own analysis of the same stream.

The texts: the 128 standing queries of ``chip_smoke.py``'s fleet phase
(``chip_smoke.fleet_queries``), a few more that fuse (offsets, filters,
other windows, default_rollup over a window), and a set that must not
fuse: quantile and median, ``@``, subqueries, ``keep_metric_names``, the
time-valued funcs, lifetime, adjustable windows left to the step, funcs
outside the core set, selections, binary operations and bare rollups.
Compared exactly: the roll-state key, func, aggregate, window, offset,
lookback, lookback delta, series limit and the selector's text, or None
on both sides."""

from types import SimpleNamespace

import pytest

import chip_smoke
from victoriametrics_tpu.ops import device_rollup as ref_dr
from victoriametrics_tpu.ops import rollup_np as ref_rnp
from victoriametrics_tpu.query import fleet as ref_fleet
from victoriametrics_tpu.query.eval import (_device_aggr_shape,
                                            _device_roll_keys)
from victoriametrics_tpu.query.exec import parse_cached
from victoriametrics_tpu.query.metricsql.ast import AggrFuncExpr
from victoriametrics_tpu.query.types import EvalConfig as RefEvalConfig
from victoriametrics_tpu_torch.query import cuda_engine as ce
from victoriametrics_tpu_torch.query.types import EvalConfig

LOOKBACK_DELTA = 300_000
MAX_SERIES = 1_000_000
TENANT = (3, 7)

FUSING = [
    ("sum by (instance)(rate(http_requests_total[5m] offset 1m))", 60_000),
    ('avg without (id)(increase(http_requests_total{job="a"}[10m]))',
     15_000),
    ('max(delta(m{a=~"x.*", b!="y"}[2m]))', 60_000),
    ("count(changes(m[1h]))", 60_000),
    ("group(max_over_time(m[5m]))", 60_000),
    ("stddev by (a, b)(deriv(m[5m]))", 30_000),
    ("stdvar(idelta(m[90s]))", 15_000),
    ("min(m[5m])", 60_000),                         # default_rollup
    ("sum(rate(m[5i]))", 60_000),                   # a step-based window
    ("sum(rate(m[5m] offset -1m))", 60_000),
    ('sum(rate({__name__="m", job="a"}[5m]))', 60_000),
    ('sum(rate(m{a="b" or c="d"}[5m]))', 60_000),
    ("sum(rate(m[5m])) by (a) limit 3", 60_000),
    ('sum({a="b"}[5m])', 60_000),                 # a nameless selector
]
NOT_FUSING = [
    "quantile by (instance)(0.9, rate(m[5m]))",
    "quantile(0.5, rate(m[5m]))",
    "median(rate(m[5m]))",
    "sum(rate(m[5m] @ 1700000000))",
    "sum(rate(m[5m] @ end()))",
    "sum(rate(m[5m:1m]))",
    "sum(max_over_time(rate(m[5m])[30m:1m]))",
    "sum(rate(m[5m]) keep_metric_names)",
    "sum(timestamp(m[5m]))",
    "sum(tfirst_over_time(m[5m]))",
    "sum(tlast_over_time(m[5m]))",
    "sum(lifetime(m[5m]))",
    "sum(rate(m))",
    "sum(irate(m))",
    "sum(default_rollup(m))",
    "sum(m)",
    "sum(holt_winters(m[5m], 0.5, 0.5))",
    "sum(quantile_over_time(0.9, m[5m]))",
    "topk(3, rate(m[5m]))",
    "count_values(\"v\", rate(m[5m]))",
    "sum(rate(m[5m])) + 1",
    "rate(m[5m])",
    "sum(abs(rate(m[5m])))",
]


def _cases():
    out = [pytest.param(q, step, dur, id=f"fleet{i}")
           for i, (q, step, dur, *_) in
           enumerate(chip_smoke.fleet_queries())]
    out += [pytest.param(q, step, 3_600_000, id=f"fusing{i}")
            for i, (q, step) in enumerate(FUSING)]
    out += [pytest.param(q, 60_000, 3_600_000, id=f"declined{i}")
            for i, q in enumerate(NOT_FUSING)]
    return out


class _PortAPI:
    def __init__(self):
        self.storage = None

    def _ec(self, start, end, step, tenant=(0, 0)):
        return EvalConfig(start=start, end=end, step=step,
                          lookback_delta=LOOKBACK_DELTA,
                          max_series=MAX_SERIES, tenant=tenant)


class _RefAPI(_PortAPI):
    def _ec(self, start, end, step, tenant=(0, 0)):
        return RefEvalConfig(start=start, end=end, step=step,
                             lookback_delta=LOOKBACK_DELTA,
                             max_series=MAX_SERIES, tenant=tenant)


def _stream(q, step, dur):
    return SimpleNamespace(q=q, step=step, duration=dur, tenant=TENANT)


def _reference_analysis(q, step, dur):
    """The reference's shape and keys, composed as its fleet does."""
    e = parse_cached(q)
    if not isinstance(e, AggrFuncExpr):
        return None
    shape = _device_aggr_shape(e)
    if shape is None:
        return None
    phi, func, rarg = shape
    if phi is not None or e.name not in ref_dr.FLEET_AGGR_CODES or \
            func not in ref_rnp.CORE_SUPPORTED:
        return None
    window = rarg.window.value_ms(step) if rarg.window is not None else 0
    offset = rarg.offset.value_ms(step) if rarg.offset is not None else 0
    ec = RefEvalConfig(start=0, end=dur, step=step,
                       lookback_delta=LOOKBACK_DELTA, max_series=MAX_SERIES,
                       tenant=TENANT)
    skey, _ = _device_roll_keys(ec, e, func, rarg, phi, window)
    if skey is None:
        return None
    lookback = window if window > 0 else (
        LOOKBACK_DELTA if func == "default_rollup" else step)
    return {"skey": skey, "func": func, "aggr": e.name, "window": window,
            "offset": offset, "lookback": lookback,
            "lookback_delta": LOOKBACK_DELTA, "max_series": MAX_SERIES,
            "me": str(rarg.expr)}


KEYS = ("skey", "func", "aggr", "window", "offset", "lookback",
        "lookback_delta", "max_series")


def _port_analysis(q, step, dur):
    plane = ce.CUDAEngine(device="cpu").fleet()
    info = plane._analyze(_PortAPI(), _stream(q, step, dur))
    if info is None:
        return None
    return {**{k: info[k] for k in KEYS}, "me": str(info["me"])}


def test_the_cases_hold_the_fleet_phase():
    qs = chip_smoke.fleet_queries()
    assert len(qs) == 128 and len({q for q, *_ in qs}) == 128
    # 128 members: each text names a roll-state key of its own
    assert len({_port_analysis(q, step, dur)["skey"]
                for q, step, dur, *_ in qs}) == 128


@pytest.mark.parametrize("q,step,dur", _cases())
def test_analysis_equals_the_reference(q, step, dur):
    want = _reference_analysis(q, step, dur)
    assert _port_analysis(q, step, dur) == want
    if q in NOT_FUSING:
        assert want is None
    else:
        assert want is not None and want["skey"][1] == want["me"]


@pytest.mark.parametrize("q,step,dur", _cases())
def test_analysis_equals_the_reference_plane(q, step, dur):
    """The reference fleet plane's own analysis of the same stream."""
    info = ref_fleet.FleetPlane._analyze_uncached(
        None, _RefAPI(), _stream(q, step, dur))
    want = None if info is None else \
        {**{k: info[k] for k in KEYS}, "me": str(info["me"])}
    assert _port_analysis(q, step, dur) == want
    if info is not None:
        got = ce.CUDAEngine(device="cpu").fleet()._analyze(
            _PortAPI(), _stream(q, step, dur))
        assert (got["aggr_code"], got["drop_stale"]) == \
            (info["aggr_code"], info["drop_stale"])
