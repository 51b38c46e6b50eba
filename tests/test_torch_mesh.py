"""Port parity for the mesh layer (victoriametrics_tpu_torch/parallel) and
the fused decode + rollup, through their plain PyTorch versions on the
CPU, against the JAX package on the 8 forced host devices of
tests/conftest.py.  The port's meshes are ["cpu"] * 8; the same
numpy-seeded inputs feed both sides.

  * the partition-rule table, padding and placement;
  * B13 sharded_rollup_aggregate: 8 aggregates x {rate, increase,
    max_over_time, stddev_over_time, timestamp} on a series-sharded
    (8, 1) mesh, against the reference's sharded_rollup_aggregate at its
    own rtol and atol of 1e-9 (timestamp under stddev/stdvar with the
    port's mean^2-ulp allowance, ROADMAP section C), and against the
    port's unsharded rollup_aggregate_tile: count, group, min and max
    equal, the sums at rtol 1e-12;
  * B15 time_sharded_rollup on a (2, 4) mesh, for every CORE_SUPPORTED
    func but lifetime, at 1e-9; lifetime and an indivisible T raise;
  * B14 cached_fleet_rollup_aggregate on an 8-way stream mesh, against
    the reference's at tests/test_torch_fleet_kernels.py's tolerances;
  * B12 decode_and_rollup for every CORE_SUPPORTED func, against the
    reference's (float64) at B5's tolerances, and equal to
    decode_tiles_plain -> rollup_tile_plain bit for bit.

The series-sharded fixture puts -0.0, NaN, counter resets and gaps in
different shards; the time-sharded one has gaps (valid false) and resets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from victoriametrics_tpu.ops import decimal as ref_dec
from victoriametrics_tpu.ops import device_decode as ref_dd
from victoriametrics_tpu.ops import device_rollup as ref_dr
from victoriametrics_tpu.ops.rollup_np import RollupConfig as RefConfig
from victoriametrics_tpu.parallel import mesh as ref_mesh
from victoriametrics_tpu.parallel import partition as ref_part
from victoriametrics_tpu_torch import convert
from victoriametrics_tpu_torch.ops import device_decode as dd
from victoriametrics_tpu_torch.ops import device_rollup as dr
from victoriametrics_tpu_torch.ops.rollup_np import (CORE_SUPPORTED,
                                                     RollupConfig)
from victoriametrics_tpu_torch.parallel import mesh as ml
from victoriametrics_tpu_torch.parallel import partition as pt

START = 1_753_700_000_000
CFG = RollupConfig(start=START + 600_000, end=START + 1_800_000,
                   step=60_000, window=300_000)
CPU8 = ["cpu"] * 8
N_GROUPS = 5  # group 4 stays empty


def _ref_cfg(cfg):
    return RefConfig(cfg.start, cfg.end, cfg.step, cfg.window)


# -- partition rules ----------------------------------------------------------

RULE_NAMES = ("fleet_ts", "fleet_values", "fleet_vals", "fleet_out",
              "fleet_counts", "fleet_gids", "fleet_v0", "fleet_shift",
              "fleet_min_ts", "fleet_aggr", "ts", "values", "vals", "ts_d2",
              "val_d2", "counts", "group_ids", "gids", "slots", "v0",
              "scale", "ts_first", "val_first", "ts_fdelta", "val_fdelta",
              "out", "shift", "min_ts", "phi")


@pytest.mark.parametrize("name", RULE_NAMES)
def test_partition_rules_match_the_reference(name):
    for ndim in range(4):
        want = tuple(ref_part.match_partition_rules(name, ndim))
        assert pt.match_partition_rules(name, ndim) == want, (name, ndim)


def test_partition_rules_refuse_unknown_leaves():
    with pytest.raises(ValueError, match="no partition rule"):
        pt.match_partition_rules("mystery", 2)
    with pytest.raises(ValueError, match="no partition rule"):
        ref_part.match_partition_rules("mystery", 2)


def test_padding_and_placement_match_the_reference():
    rmesh = ref_mesh.make_mesh(n_series=8)
    mesh = convert.mesh_from_reference(dict(rmesh.shape), CPU8)
    assert mesh.shape == {"series": 8, "time": 1}
    assert pt.row_multiple(mesh) == ref_part.row_multiple(rmesh) == 8
    for axis in ("series", "time", "stream"):
        assert pt.axis_multiple(mesh, axis) == \
            ref_part.axis_multiple(rmesh, axis)
    a = np.arange(13 * 3, dtype=np.int32).reshape(13, 3)
    np.testing.assert_array_equal(pt.pad_rows_to_mesh(mesh, a, 7),
                                  ref_part.pad_rows_to_mesh(rmesh, a, 7))
    shards = pt.shard_put(mesh, "ts", a, 7)
    placed = np.asarray(ref_part.shard_put(rmesh, "ts", a, 7))
    assert len(shards) == 8 and all(s.shape == (2, 3) for s in shards)
    np.testing.assert_array_equal(torch.cat(shards).numpy(), placed)
    # logical shards of one device are row views of one upload
    assert len({s.untyped_storage().data_ptr() for s in shards}) == 1


def test_mesh_shapes_and_device_rules():
    mesh = ml.make_mesh(2, 4, CPU8)
    assert mesh.shape == {"series": 2, "time": 4}
    assert mesh == ml.make_mesh(2, 4, CPU8) and len({mesh, ml.make_mesh(
        2, 4, CPU8)}) == 1
    assert ml.make_fleet_mesh(CPU8).shape == {"stream": 8}
    with pytest.raises(ValueError):
        ml.make_mesh(3, 2, CPU8)
    with pytest.raises(ValueError, match="CPU or on CUDA"):
        ml.make_mesh(2, 1, ["cpu", "meta"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ml.make_mesh()


# -- B13 ----------------------------------------------------------------------

def _series(rng, n, kind):
    ts = np.sort(np.arange(n, dtype=np.int64) * 15_000 + START +
                 rng.integers(-2000, 2000, n))
    v = np.cumsum(rng.integers(0, 50, n)).astype(np.float64)
    if kind == "gauge":
        v = np.round(rng.uniform(-50, 100, n), 3)
        v[rng.integers(0, n)] = -0.0
    elif kind == "resets":
        for p in rng.integers(1, n, 3):
            v[p:] -= v[p]
        v = np.abs(v)
    elif kind == "negative":
        v[n // 2:] -= v[n // 2] + 40.0
    elif kind == "nan":
        v[n // 3] = np.nan
    elif kind == "negzero":
        v[:3] = -0.0
    elif kind == "gap":
        keep = np.sort(rng.choice(n, max(n // 5, 2), replace=False))
        ts, v = ts[keep], v[keep]
    return ts, v


SHARD_KINDS = ("counter", "gauge", "resets", "negative", "nan", "negzero",
               "gap", "counter")


def _sharded_tile():
    """40 rows (5 per shard), each shard a different mix of kinds."""
    rng = np.random.default_rng(17)
    series = [_series(rng, int(rng.integers(4, 140)),
                      SHARD_KINDS[(i * 3 + i // 5) % len(SHARD_KINDS)])
              for i in range(40)]
    ts, vals, counts = dr.pack_series(series, CFG.start)
    gids = (np.arange(40) * 7 % (N_GROUPS - 1)).astype(np.int32)
    return ts, vals, counts, gids


SHARDED = _sharded_tile()
B13_FUNCS = ("rate", "increase", "max_over_time", "stddev_over_time",
             "timestamp")


def _port_sharded(mesh, ts, vals, counts, gids):
    shards = [convert.shards_from_reference(mesh, n, a) for n, a in
              (("ts", ts), ("values", vals), ("counts", counts))]
    layouts = [dr.group_layout(g.numpy(), N_GROUPS, "cpu")
               for g in convert.shards_from_reference(mesh, "gids", gids)]
    return shards, layouts


def _close_aggr(got, want, aggr, func, mean=None, rtol=1e-9, atol=1e-9):
    if func == "stddev_over_time":
        rtol, atol = 1e-6, 1e-4
    if aggr == "stddev":
        got, want = got * got, want * want
    if aggr in ("stddev", "stdvar") and mean is not None:
        atol = atol + 16 * np.finfo(np.float64).eps * (
            1 + np.nan_to_num(mean) ** 2)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    bad = np.abs(got - want) > atol + rtol * np.abs(want)
    assert not np.any(bad & ~np.isnan(want)), (got[bad], want[bad])


@pytest.mark.parametrize("func", B13_FUNCS)
def test_sharded_rollup_aggregate_matches_reference(func):
    ts, vals, counts, gids = SHARDED
    rmesh = ref_mesh.make_mesh(n_series=8)
    mesh = convert.mesh_from_reference(dict(rmesh.shape), CPU8)
    (ts_s, v_s, c_s), layouts = _port_sharded(mesh, ts, vals, counts, gids)
    cfg = dr.normalized_cfg(func, CFG)
    t_full = tuple(torch.from_numpy(a) for a in (ts, vals, counts))
    groups = dr.group_layout(gids, N_GROUPS, "cpu")
    mean = dr.rollup_aggregate_tile(func, "avg", *t_full, groups,
                                    cfg).numpy()
    for aggr in dr.AGGR_FUNCS:
        fn = ref_mesh.sharded_rollup_aggregate(rmesh, func, aggr,
                                               _ref_cfg(cfg), N_GROUPS)
        want = np.asarray(fn(jnp.asarray(ts), jnp.asarray(vals),
                             jnp.asarray(counts), jnp.asarray(gids),
                             np.int32(0), ref_dr.MIN_TS_NONE))
        port = ml.cached_sharded_rollup_aggregate(mesh, func, aggr, cfg,
                                                  N_GROUPS)
        assert port is ml.cached_sharded_rollup_aggregate(
            mesh, func, aggr, cfg, N_GROUPS)
        got = port(ts_s, v_s, c_s, layouts).numpy()
        assert got.shape == want.shape == (N_GROUPS, dr.num_steps(cfg))
        assert np.isnan(got[N_GROUPS - 1]).all()
        assert np.isfinite(got).sum() > 20
        # timestamp's variance is cancellation noise: the mean^2-ulp term
        m = mean if func in dr.TIME_VALUED_FUNCS else None
        _close_aggr(got, want, aggr, func, m)
        # against the unsharded fused kernel: the counts and extrema are
        # the same numbers, the sums agree but for association
        flat = dr.rollup_aggregate_tile(func, aggr, *t_full, groups,
                                        cfg).numpy()
        if aggr in ("count", "group", "min", "max"):
            np.testing.assert_array_equal(got, flat)
        elif aggr in ("sum", "avg"):
            np.testing.assert_allclose(got, flat, rtol=1e-12, atol=0,
                                       equal_nan=True)
        else:
            _close_aggr(got, flat, aggr, func, mean)


def test_combine_folds_shards_in_order():
    """The plain combine keeps the earlier of equal extrema, so -0.0 and
    +0.0 resolve by shard order, as the unsharded walk's order."""
    mom = torch.zeros((3, 2, 1, 2), dtype=torch.float64)
    mom[:, 0] = 1.0                       # every shard has a live row
    mom[:, 1, 0, 0] = torch.tensor([-0.0, 0.0, 0.0])
    mom[:, 1, 0, 1] = torch.tensor([0.0, -0.0, -1.0])
    out = ml.combine_group_moments("min", mom)
    assert torch.signbit(out[0, 0]) and out[0, 1] == -1.0
    mom[:, 1, 0, 1] = torch.tensor([0.0, -0.0, 0.0])
    out = ml.combine_group_moments("max", mom)
    assert torch.signbit(out[0, 0]) and not torch.signbit(out[0, 1])
    counts = ml.combine_group_moments("count", mom[:, :1])
    assert counts.tolist() == [[3.0, 3.0]]


def test_sharded_call_checks_its_shards():
    ts, vals, counts, gids = SHARDED
    mesh = ml.make_mesh(8, 1, CPU8)
    (ts_s, v_s, c_s), layouts = _port_sharded(mesh, ts, vals, counts, gids)
    fn = ml.sharded_rollup_aggregate(mesh, "rate", "sum",
                                     dr.normalized_cfg("rate", CFG), N_GROUPS)
    with pytest.raises(ValueError, match="8 series shards"):
        fn(ts_s[:4], v_s[:4], c_s[:4], layouts[:4])
    with pytest.raises(ValueError):
        ml.sharded_rollup_aggregate(mesh, "rate", "median", CFG, N_GROUPS)


# -- B15 ----------------------------------------------------------------------

def _time_tile():
    """8 rows x 512 samples at 10 s, every tenth-ish sample missing
    (valid false) and two counter resets per row."""
    rng = np.random.default_rng(31)
    S, N, interval = 8, 512, 10_000
    ts = np.tile(np.arange(N, dtype=np.int64) * interval, (S, 1))
    vals = np.cumsum(rng.integers(0, 20, (S, N)), axis=1).astype(np.float64)
    for r in range(S):
        for p in rng.integers(1, N, 2):
            vals[r, p:] -= vals[r, p]
    vals = np.abs(vals)
    valid = rng.random((S, N)) > 0.1
    cfg = RollupConfig(start=0, end=N * interval - interval,
                       step=interval * 4, window=interval * 8)
    return ts.astype(np.int32), vals, valid, cfg


TIME = _time_tile()
B15_FUNCS = [f for f in CORE_SUPPORTED if f != "lifetime"]


@pytest.mark.parametrize("func", B15_FUNCS)
def test_time_sharded_rollup_matches_reference(func):
    ts, vals, valid, cfg = TIME
    rmesh = ref_mesh.make_mesh(n_series=2, n_time=4)
    mesh = convert.mesh_from_reference(dict(rmesh.shape), CPU8)
    halo = 16  # > window / interval + 2
    want = np.asarray(ref_mesh.time_sharded_rollup(
        rmesh, func, _ref_cfg(cfg), halo)(
            jnp.asarray(ts), jnp.asarray(vals), jnp.asarray(valid)))
    step = ml.time_sharded_rollup(mesh, func, cfg, halo)
    got = step(*(ml.split_2d(mesh, torch.from_numpy(a))
                 for a in (ts, vals, valid))).numpy()
    assert got.shape == want.shape
    assert np.isfinite(want).sum() > 100
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if func == "stddev_over_time":  # through its square
        np.testing.assert_allclose(got * got, want * want, rtol=1e-9,
                                   atol=1e-9, equal_nan=True)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9,
                                   equal_nan=True)


def test_time_sharded_rollup_refuses_what_the_reference_refuses():
    mesh = ml.make_mesh(2, 4, CPU8)
    with pytest.raises(ValueError, match="whole-series"):
        ml.time_sharded_rollup(mesh, "lifetime", CFG, 8)
    with pytest.raises(ValueError, match="not divisible"):
        ml.time_sharded_rollup(mesh, "rate", RollupConfig(0, 40_000, 10_000,
                                                          20_000), 8)


def test_halo_compaction_keeps_time_order():
    """The plain halo compaction: halo before local, valid samples first
    in time order, the rest 2^31 - 1 - shift / 0.0 past the count."""
    ts = torch.tensor([[10, 20, 30, 40]], dtype=torch.int32)
    vals = torch.tensor([[1.0, 2.0, 3.0, 4.0]], dtype=torch.float64)
    valid = torch.tensor([[True, False, True, True]])
    h_ts = torch.tensor([[5, 7]], dtype=torch.int32)
    h_vals = torch.tensor([[0.5, 0.7]], dtype=torch.float64)
    h_valid = torch.tensor([[False, True]])
    t, v, c = ml.halo_compact(ts, vals, valid, h_ts, h_vals, h_valid, 3)
    assert c.tolist() == [4]
    assert t[0, :4].tolist() == [4, 7, 27, 37]
    assert v[0].tolist() == [0.7, 1.0, 3.0, 4.0, 0.0, 0.0]
    assert t[0, 4:].tolist() == [2**31 - 4] * 2
    t0, _, c0 = ml.halo_compact(ts, vals, valid, None, None, None, 0)
    assert c0.tolist() == [3] and t0[0, :3].tolist() == [10, 30, 40]


# -- B14 ----------------------------------------------------------------------

def _fleet_bucket(B=16, S=12, N=96, seed=5):
    rng = np.random.default_rng(seed)
    ts = np.full((B, S, N), int(dr.TS_PAD), np.int32)
    vals = np.zeros((B, S, N), np.float64)
    counts = np.zeros((B, S), np.int32)
    gids = np.zeros((B, S), np.int32)
    kinds = ("counter", "gauge", "resets", "negative", "nan", "negzero")
    for b in range(B - 3):  # three padded slots
        for r in range(S - 2):
            t, v = _series(rng, int(rng.integers(2, N - 4)),
                           kinds[(r + b) % len(kinds)])
            t = t - START + 30_000
            counts[b, r] = t.size
            ts[b, r, :t.size] = t
            vals[b, r, :t.size] = v
            gids[b, r] = (r * 5 + b) % (N_GROUPS - 1)
    aggr = (np.arange(B) % 8).astype(np.int32)
    shift = ((np.arange(B) % 4) * 60_000).astype(np.int32)
    min_ts = np.where(np.arange(B) % 3, -600_000,
                      int(dr.MIN_TS_NONE)).astype(np.int32)
    v0 = np.zeros((B, S), np.float64)
    return ts, vals, counts, gids, aggr, shift, min_ts, v0


FLEET = _fleet_bucket()
FLEET_CFG = RollupConfig(0, 15 * 60_000, 60_000, 300_000)


@pytest.mark.parametrize("func", ["rate", "increase", "max_over_time",
                                  "irate"])
def test_stream_sharded_fleet_matches_reference(func):
    ts, vals, counts, gids, aggr, shift, min_ts, v0 = FLEET
    rmesh = ref_mesh.make_fleet_mesh()
    mesh = convert.mesh_from_reference(dict(rmesh.shape), CPU8)
    cfg = dr.normalized_cfg(func, FLEET_CFG)
    want = np.asarray(ref_mesh.cached_fleet_rollup_aggregate(
        rmesh, func, _ref_cfg(cfg), N_GROUPS)(
            *(jnp.asarray(a) for a in (ts, vals, counts, gids, aggr, shift,
                                       min_ts, v0))))
    sh = {n: convert.shards_from_reference(mesh, n, a) for n, a in (
        ("fleet_ts", ts), ("fleet_values", vals), ("fleet_counts", counts),
        ("fleet_gids", gids), ("fleet_aggr", aggr), ("fleet_shift", shift),
        ("fleet_min_ts", min_ts), ("fleet_v0", v0))}
    layouts = [dr.fleet_layout(g, N_GROUPS, "cpu") for g in sh["fleet_gids"]]
    fn = ml.cached_fleet_rollup_aggregate(mesh, func, cfg, N_GROUPS)
    got = fn(sh["fleet_ts"], sh["fleet_values"], sh["fleet_counts"], layouts,
             sh["fleet_aggr"], sh["fleet_shift"], sh["fleet_min_ts"],
             sh["fleet_v0"]).numpy()
    assert got.shape == want.shape
    # the unsharded fleet kernel on the same bucket, bit for bit
    flat = dr.fleet_rollup_aggregate_tile(
        func, cfg, dr.fleet_layout(gids, N_GROUPS, "cpu"),
        *(torch.from_numpy(a) for a in (ts, vals, counts, aggr, shift,
                                        min_ts, v0))).numpy()
    np.testing.assert_array_equal(got.view(np.int64), flat.view(np.int64))
    inv = {c: a for a, c in dr.FLEET_AGGR_CODES.items()}
    for b in range(ts.shape[0]):
        a = inv[int(aggr[b])]
        if a in ("stddev", "stdvar"):
            _close_aggr(got[b], want[b], a, func)
        else:
            np.testing.assert_allclose(got[b], want[b], rtol=1e-12, atol=0,
                                       equal_nan=True)


# -- B12 ----------------------------------------------------------------------

def _planes():
    rng = np.random.default_rng(41)
    series = []
    for i in range(24):
        n = int(rng.integers(3, 200))
        ts = np.sort(np.arange(n, dtype=np.int64) * 15_000 + START +
                     rng.integers(-500, 500, n))
        v = np.cumsum(rng.integers(0, 50, n))
        if i % 4 == 1:
            for p in rng.integers(1, n, 2):
                v[p:] -= v[p]
            v = np.abs(v)
        elif i % 4 == 2:
            v = rng.integers(-2000, 2000, n)
        v = v / 100.0
        m, e = ref_dec.float_to_decimal(v)
        series.append((ts, m, e))
    return ref_dd.pack_delta_planes(series, CFG.start, np.float64)


PLANES = _planes()
B12_LOOSE = {"deriv", "stddev_over_time", "stdvar_over_time"}


@pytest.mark.parametrize("func", list(CORE_SUPPORTED))
def test_decode_and_rollup_matches_reference(func):
    p = PLANES
    n = int(p.counts.max())
    cfg = CFG
    fields = ("ts_first", "ts_fdelta", "ts_d2", "val_first", "val_fdelta",
              "val_d2", "scale", "counts")
    want = np.asarray(ref_dd.decode_and_rollup(
        func, *(jnp.asarray(getattr(p, f)) for f in fields), _ref_cfg(cfg),
        n, np.float64))
    args = convert.planes_from_reference(p, "cpu")
    got = dd.decode_and_rollup(func, *args, cfg, n).numpy()
    ts, vals = dd.decode_tiles_plain(*args, n)
    plain = dr.rollup_tile_plain(func, ts, vals, args[7], cfg).numpy()
    np.testing.assert_array_equal(got.view(np.int64), plain.view(np.int64))
    assert np.isfinite(want).sum() > 50
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if func == "stddev_over_time":
        np.testing.assert_allclose(got * got, want * want, rtol=1e-9,
                                   atol=1e-9)
    elif func in B12_LOOSE:
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    elif func == "idelta":
        # the reference's fused program contracts mant * scale - prev into
        # a multiply-add: two equal samples leave the product's rounding
        # residual (<= 1.2e-15 here, ROADMAP section C).  Its unfused
        # decode_tiles -> rollup_tile gives the port's numbers.
        ts_r, v_r = ref_dd.decode_tiles(
            *(jnp.asarray(getattr(p, f)) for f in fields), n, np.float64)
        unfused = np.asarray(ref_dr.rollup_tile(
            func, ts_r, v_r, jnp.asarray(p.counts), _ref_cfg(cfg)))
        np.testing.assert_allclose(got, unfused, rtol=1e-12, atol=0)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_jax_sees_eight_devices():
    assert len(jax.devices()) == 8
