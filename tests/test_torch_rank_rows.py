"""B7 rank_tile's statistic on edge rows, and its median's plan.

  * rank_plan (ops/device_rollup.py): a warp per row up to 1024 steps,
    8 rows a block (64 KiB of staged keys at most; fewer where rows are
    few, so no SM is left without a block), a block per row with the row
    staged up to 24,576 steps (the kernel's kStageMax), global memory
    above;
  * rank_rows_plain against the reference's rank_tile (the JAX package,
    on the CPU) on rows made to hold the edge cases of each kind: no live
    step, one, two; ties straddling the median; -0.0 and +0.0 at j0 and
    j1; infinities; a constant row; a run of ties with one outlier; rows
    of T below and above 32 and not a multiple of it.  The rolled rows
    are last_over_time of one sample at every grid point (NaN values
    where a step has no value), so both sides rank the same tile; the
    median and last are exact, avg within rtol 1e-12 (the sums' order),
    max and min equal as numbers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from victoriametrics_tpu.ops import device_rollup as ref
from victoriametrics_tpu.ops.rollup_np import RollupConfig as RefConfig
from victoriametrics_tpu_torch.ops import device_rollup as dr
from victoriametrics_tpu_torch.ops.rollup_np import RollupConfig

STEP = 15_000


@pytest.mark.parametrize("S,T,want", [
    (8192, 355, (dr.RANK_WARP, 8)),       # the dashboard
    (8192, 1024, (dr.RANK_WARP, 8)),      # 64 KiB of keys a block
    (8192, 1500, (dr.RANK_BLOCK, 1)),
    (100_000, 5761, (dr.RANK_BLOCK, 1)),  # the full width
    (64, 24_576, (dr.RANK_BLOCK, 1)),     # the most a block stages
    (64, 24_577, (dr.RANK_GLOBAL, 1)),
    (64, 30_000, (dr.RANK_GLOBAL, 1)),    # chip_smoke.py's wide tile
    (200, 355, (dr.RANK_WARP, 2)),        # few rows: every SM a block
    (5, 40, (dr.RANK_WARP, 1)),
    (8192, 1, (dr.RANK_WARP, 8)),
])
def test_rank_plan(S, T, want):
    p = dr.rank_plan(S, T, 132)
    assert (p.path, p.rows) == want
    if p.path == dr.RANK_WARP:
        assert p.smem == 8 * p.rows * T <= 64 << 10
    elif p.path == dr.RANK_BLOCK:
        assert p.smem == 8 * T <= 192 << 10
    else:
        assert p.smem == 0


def edge_rows(T: int, seed: int) -> np.ndarray:
    """Rows of T steps, each an edge case of some kind, the live values
    at shuffled steps (NaN elsewhere)."""
    rng = np.random.default_rng(seed)
    h = T // 2
    cases = [
        [], [1.5], [2.0, -3.0],                      # n = 0, 1, 2
        [1.0] * h + [2.0] * (T - h),                 # ties straddling
        [1.0] * (h + 1) + [2.0] * (T - h - 1),
        [-0.0, 0.0], [0.0, -0.0, 0.0],               # zeros at j0, j1
        [-0.0] * h + [0.0] * (T - h),
        [np.inf, -np.inf] * h, [np.inf] * T,         # infinities
        [-np.inf] * 3 + [np.inf] * 2,
        [7.25] * T, [7.25] * (T - 1), [-0.0] * T,    # constant rows
        [0.0] * (T - 1) + [1e300],                   # ties, an outlier
        [-1e300] + [5.0] * (T - 1),
        list(rng.normal(0, 1, T)),
        list(rng.integers(0, 3, T).astype(np.float64)),
    ]
    out = np.full((len(cases), T), np.nan)
    for r, vals in enumerate(cases):
        vals = np.asarray(vals[:T], dtype=np.float64)
        out[r, rng.permutation(T)[:vals.size]] = vals
    return out


@pytest.mark.parametrize("T", [1, 2, 20, 33, 45, 96])
@pytest.mark.parametrize("kind", sorted(dr.RANK_KINDS))
def test_rank_rows_plain_matches_reference_on_edge_rows(T, kind):
    rolled = edge_rows(T, T)
    S = rolled.shape[0]
    ts = np.tile(np.arange(T, dtype=np.int32) * STEP, (S, 1))
    counts = np.full(S, T, np.int32)
    cfg = RollupConfig(0, (T - 1) * STEP, STEP, STEP)
    w_rolled, w_rank = ref.rank_tile(
        "last_over_time", kind, jnp.asarray(ts), jnp.asarray(rolled),
        jnp.asarray(counts), RefConfig(cfg.start, cfg.end, cfg.step,
                                       cfg.window))
    # the tile rolls up to the rows themselves, bit for bit
    np.testing.assert_array_equal(np.asarray(w_rolled).view(np.int64),
                                  rolled.view(np.int64))
    got = dr.rank_rows_plain(torch.from_numpy(rolled), kind).numpy()
    want = np.asarray(w_rank)
    if kind in ("median", "last"):
        np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12 if kind == "avg"
                                   else 0.0, atol=0.0, equal_nan=True)
