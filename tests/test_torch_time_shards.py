"""B15 time_sharded_rollup: how its kernels batch a mesh's shards, which
rows they may read in place, and its plain path against the reference.

  * time_shard_batches: a card's shards are one launch per phase (at most
    16 a launch), in row-major order; shards of distinct cards batch per
    card;
  * the halo pass's descriptors: a shard whose halo and columns are views
    of one tile reads its all-valid rows in place (the in-place row starts
    at the halo's first column); a halo copied from elsewhere compacts
    every row; the first time shard has no halo and reads in place;
  * the port's time_sharded_rollup on a (2, 4) mesh of ["cpu"] * 8 (its
    plain path) against the reference's on the 8 forced host devices of
    tests/conftest.py: gaps at the shard boundaries and inside a halo, an
    all-valid tile, a halo wider than a shard (clipped to it), and the
    time-valued funcs, at test_torch_mesh.py's 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from victoriametrics_tpu.ops.rollup_np import RollupConfig as RefConfig
from victoriametrics_tpu.parallel import mesh as ref_mesh
from victoriametrics_tpu_torch import convert
from victoriametrics_tpu_torch.ops import device_rollup as dr
from victoriametrics_tpu_torch.ops.rollup_np import RollupConfig
from victoriametrics_tpu_torch.parallel import mesh as ml

CPU8 = ["cpu"] * 8
S, N, INTERVAL = 8, 512, 10_000
C = N // 4
CFG = RollupConfig(start=0, end=N * INTERVAL - INTERVAL, step=INTERVAL * 4,
                   window=INTERVAL * 8)


def test_one_card_is_one_batch():
    cuda0 = torch.device("cuda", 0)
    mesh = ml.make_mesh(2, 4, [cuda0] * 8)
    assert ml.time_shard_batches(mesh) == [
        (cuda0, [(i, j) for i in range(2) for j in range(4)])]
    assert ml.time_shard_batches(ml.make_mesh(2, 4, CPU8)) == [
        (torch.device("cpu"), [(i, j) for i in range(2) for j in range(4)])]


def test_cards_batch_apart_and_in_sixteens():
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    mesh = ml.make_mesh(2, 4, [d0, d1] * 4)
    assert ml.time_shard_batches(mesh) == [
        (d0, [(0, 0), (0, 2), (1, 0), (1, 2)]),
        (d1, [(0, 1), (0, 3), (1, 1), (1, 3)])]
    big = ml.time_shard_batches(ml.make_mesh(5, 4, [d0] * 20))
    assert [(d, len(p)) for d, p in big] == [(d0, 16), (d0, 4)]
    assert [p for _, b in big for p in b] == [(i, j) for i in range(5)
                                              for j in range(4)]


def _shards(halo_copy: bool):
    mesh = ml.make_mesh(2, 4, CPU8)
    ts = torch.arange(S * N, dtype=torch.int32).reshape(S, N)
    vals = ts.double()
    valid = torch.ones((S, N), dtype=torch.bool)
    parts = [ml.split_2d(mesh, a) for a in (ts, vals, valid)]
    H = 16
    out = torch.empty((S, 40), dtype=torch.float64)
    shards = []
    for j in range(4):
        left = None
        if j:
            left = tuple(p[1][j - 1] for p in parts)
            if halo_copy:  # as from another card: the tail only
                left = tuple(x[:, -H:].clone() for x in left)
        shards.append(ml.TimeShard(*(p[1][j] for p in parts), left,
                                   H if j else 0, j * 1000, out, S // 2,
                                   8 * j))
    return shards


@pytest.mark.parametrize("halo_copy", [False, True])
def test_halo_descriptors(halo_copy):
    shards = _shards(halo_copy)
    Hs = [0, 16, 16, 16]
    halo = np.asarray(ml._halo_desc(shards, torch.device("cpu"))).reshape(
        4, 15)
    rows = np.asarray(ml._shard_desc(shards, 8)).reshape(4, 9)
    # rows, H, inplace: the first time shard reads in place (no halo);
    # the others where their halo is their left neighbour's tail in the
    # same tile rows
    assert halo[:, 12].tolist() == [S // 2] * 4
    assert halo[:, 13].tolist() == Hs
    assert halo[:, 14].tolist() == [1] + [0 if halo_copy else 1] * 3
    for sh, h, r, H in zip(shards, halo, rows, Hs):
        assert h[0] == sh.ts.data_ptr() and h[1] == N
        assert h[4] == sh.valid.data_ptr() and h[5] == N
        if H:  # the halo: the last H columns of the left arrays
            for k, x in enumerate(sh.left):
                assert h[6 + 2 * k] == x[:, -H:].data_ptr()
                assert h[7 + 2 * k] == x.stride(0)
        # a row read in place starts at the halo's first column
        assert r[0] == sh.ts.data_ptr() - 4 * H and r[1] == N
        assert r[2] == sh.values.data_ptr() - 8 * H and r[3] == N
        assert r[4:7].tolist() == [H + C, S // 2, sh.shift]
        # its block of the output: rows S/2 on, columns 8 j on
        assert r[7] == sh.out[S // 2:, sh.out_col0:].data_ptr()
        assert r[8] == 40
        if H and not halo_copy:
            assert r[0] == h[6] and r[2] == h[8]


def test_in_place_needs_the_halo_right_before_the_columns():
    a = torch.zeros((4, 10), dtype=torch.int32)
    v, f = a.double(), a.bool()
    out = torch.empty((4, 2), dtype=torch.float64)

    def inplace(left_ts, cur_ts):
        sh = ml.TimeShard(cur_ts, v[:, 5:9], f[:, 5:9],
                          (left_ts, v[:, 1:5], f[:, 1:5]), 2, 0, out)
        return ml._halo_desc([sh], torch.device("cpu"))[14]

    assert inplace(a[:, 1:5], a[:, 5:9]) == 1
    assert inplace(a[:, 0:4], a[:, 5:9]) == 0       # a column apart
    assert inplace(a[:, 1:5].clone(), a[:, 5:9]) == 0
    wide = torch.zeros((4, 20), dtype=torch.int32)  # another row stride
    assert inplace(wide[:, 1:5], a[:, 5:9]) == 0
    with pytest.raises(ValueError, match="halo"):
        inplace(a[:, 4:5], a[:, 5:9])               # narrower than H


def _tile(case: str, seed: int = 41):
    """S rows x N samples at 10 s (two counter resets a row) and their
    valid flags for `case`."""
    rng = np.random.default_rng(seed)
    ts = np.tile(np.arange(N, dtype=np.int64) * INTERVAL, (S, 1))
    ts = ts + rng.integers(-2_000, 2_001, (S, N))
    vals = np.cumsum(rng.integers(0, 20, (S, N)), axis=1).astype(np.float64)
    for r in range(S):
        for p in rng.integers(1, N, 2):
            vals[r, p:] -= vals[r, p]
    vals = np.abs(vals)
    valid = np.ones((S, N), bool)
    if case == "boundaries":
        valid[0::2, C - 3:C + 2] = False        # across shards 0 | 1
        valid[1::3, C - 12:C - 9] = False       # inside shard 1's halo
        valid[2, 2 * C] = False                 # shard 2's first column
        valid[5, 3 * C - 1] = False             # shard 2's last: a halo
        valid[6, :] = False                     # no sample at all
        valid[7, 3 * C:] = False                # none in the last shard
    elif case == "halo_over_c":
        valid[::2, C - 40:C + 10] = False
    return ts.astype(np.int32), vals, valid


CASES = [("boundaries", 16), ("all_valid", 16), ("halo_over_c", 200)]
FUNCS = ["rate", "increase", "count_over_time", "deriv", "timestamp",
         "tlast_over_time", "tfirst_over_time"]


@pytest.mark.parametrize("func", FUNCS)
@pytest.mark.parametrize("case,halo", CASES)
def test_time_sharded_rollup_edges_match_reference(case, halo, func):
    ts, vals, valid = _tile(case)
    rmesh = ref_mesh.make_mesh(n_series=2, n_time=4)
    mesh = convert.mesh_from_reference(dict(rmesh.shape), CPU8)
    want = np.asarray(ref_mesh.time_sharded_rollup(
        rmesh, func, RefConfig(CFG.start, CFG.end, CFG.step, CFG.window),
        halo)(jnp.asarray(ts), jnp.asarray(vals), jnp.asarray(valid)))
    got = ml.time_sharded_rollup(mesh, func, CFG, halo)(
        *(ml.split_2d(mesh, torch.from_numpy(a))
          for a in (ts, vals, valid))).numpy()
    assert np.isfinite(want).sum() > 100
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9,
                               equal_nan=True)
    if case == "all_valid" and func in dr.TIME_VALUED_FUNCS:
        # the shards' grid offsets come back: absolute seconds
        assert np.nanmax(got) > 3 * C * INTERVAL / 1e3
