"""K2's Hopper redesign on the CPU: the chunk numbering of GroupLayout,
the chunked plain K2 against the JAX package, k2_plan's paths, and the
staged window search's rule against the JAX package's window bounds.

  * group_layout's order and starts against a stable numpy sort, its
    chunk numbering (slot0, slots, chunk) against a loop over the group
    sizes, on ragged groups of 0, 1, R, R + 1 and 2R + 1 members;
  * the plain K2 (rollup_tile_plain, each chunk's moments, merged in chunk
    order, finalized) with R = 16, against the reference's
    rollup_aggregate_tile for all 8 aggregates: count and group equal (NaN
    positions included), min and max equal for max_over_time and at rtol
    1e-12 for the counter funcs (a rate's last ulp differs from the
    reference's, chunked or not), sum and avg at rtol 1e-12, stddev and
    stdvar at rtol 1e-9 and atol 1e-9 (stddev through its square),
    tests/test_torch_device_rollup.py's bounds; count, group, min and max
    also equal to the unchunked plain walk's;
  * k2_plan on the dashboard, the full width, an instant query, a 1 h
    step, gappy rows and a grid that overflows int32: the staged path and
    its tile where a stage holds the rows' real spans, else the global
    search;
  * b5_plan (B5 rollup_tile on K2's staged walk) at the same shapes and
    a time shard of B15's (2, 4) mesh: its path, rows a block and tile;
  * the staged search (a transcription of csrc/rollup.cu's walk_rows:
    span_of, count_le_from and guess_count), walked as K2 walks a group's
    members and as B5 walks its row blocks, finds exactly the reference's
    window bounds (_window_bounds) on regular, jittered, gappy, bursty and
    duplicate-timestamp rows, over every step tile of the plan.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from victoriametrics_tpu.ops import device_rollup as ref
from victoriametrics_tpu.ops.rollup_np import RollupConfig as RefConfig
from victoriametrics_tpu_torch import convert
from victoriametrics_tpu_torch.ops import device_rollup as dr
from victoriametrics_tpu_torch.ops.rollup_np import RollupConfig

START = 1_753_700_000_000
R = 16


def _ref_cfg(cfg):
    return RefConfig(cfg.start, cfg.end, cfg.step, cfg.window)


# -- GroupLayout's chunks -------------------------------------------------

@pytest.mark.parametrize("chunk,sizes", [
    (16, (0, 1, 16, 17, 33)),
    (16, (33, 0, 17, 1, 16, 0)),
    (64, (0, 1, 64, 65, 129)),
    (64, (3,)),
])
def test_group_layout_numbers_chunks(monkeypatch, chunk, sizes):
    monkeypatch.setattr(dr, "FLEET_CHUNK", chunk)
    rng = np.random.default_rng(len(sizes) + chunk)
    gids = rng.permutation(np.repeat(np.arange(len(sizes)), sizes))
    gids = gids.astype(np.int32)
    lay = dr.group_layout(gids, len(sizes), "cpu")
    np.testing.assert_array_equal(lay.order.numpy(),
                                  np.argsort(gids, kind="stable"))
    np.testing.assert_array_equal(lay.starts.numpy(),
                                  np.concatenate([[0], np.cumsum(sizes)]))
    slot, slot0 = 0, []
    for n in sizes:
        slot0.append(slot)
        if n > chunk:
            slot += -(-n // chunk)
    assert lay.chunk == chunk and lay.slots == slot
    assert lay.max_group == max(sizes)
    chunked = np.array(sizes) > chunk
    np.testing.assert_array_equal(lay.slot0.numpy()[chunked],
                                  np.array(slot0)[chunked])


# -- the chunked plain K2 against the reference ---------------------------

def _counter(rng, n):
    ts = np.sort(START + np.arange(n) * 15_000 +
                 rng.integers(-2000, 2000, n))
    v = np.cumsum(rng.integers(0, 50, n)).astype(np.float64)
    return ts, v


def _chunk_tile():
    """120 counters (every 9th with a reset, one with a NaN) in groups of
    0, 1, R, R + 1, 2R + 1 and 53 members, rows of a group interleaved
    with the others'."""
    rng = np.random.default_rng(5)
    sizes = (0, 1, R, R + 1, 2 * R + 1, 53)
    gids = rng.permutation(np.repeat(np.arange(len(sizes)), sizes))
    series = []
    for i in range(len(gids)):
        ts, v = _counter(rng, int(rng.integers(40, 130)))
        if i % 9 == 0:
            v[len(v) // 2:] -= v[len(v) // 2]
        if i == 7:
            v[20] = np.nan
        series.append((ts, v))
    ts, vals, counts = dr.pack_series(series, START + 600_000)
    return ts, vals, counts, gids.astype(np.int32), len(sizes)


CHUNK_TILE = _chunk_tile()
CFG = RollupConfig(start=START + 600_000, end=START + 1_800_000,
                   step=60_000, window=300_000)


def _close(got, want, aggr, func):
    # min and max of a rate carry the per-series value's last-ulp
    # difference from the reference (rtol 1e-12, as for the unchunked K2)
    exact = ("count", "group") if func in dr.COUNTER_FUNCS else \
        ("count", "group", "min", "max")
    if aggr in exact:
        np.testing.assert_array_equal(got, want)
    elif aggr in ("sum", "avg", "min", "max"):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0,
                                   equal_nan=True)
    else:
        if aggr == "stddev":
            got, want = got * got, want * want
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9,
                                   equal_nan=True)


@pytest.mark.parametrize("aggr", list(dr.AGGR_FUNCS))
@pytest.mark.parametrize("func", ["rate", "increase", "max_over_time"])
def test_chunked_k2_matches_reference(monkeypatch, func, aggr):
    monkeypatch.setattr(dr, "FLEET_CHUNK", R)
    ts, vals, counts, gids, G = CHUNK_TILE
    cfg = dr.normalized_cfg(func, CFG)
    lay = dr.group_layout(gids, G, "cpu")
    assert lay.slots == 2 + 3 + 4  # R + 1, 2R + 1 and 53 are chunked
    want = np.asarray(ref.rollup_aggregate_tile(
        func, aggr, jnp.asarray(ts), jnp.asarray(vals), jnp.asarray(counts),
        jnp.asarray(gids), _ref_cfg(cfg), G, np.int32(0),
        ref.MIN_TS_NONE))
    t = convert.tiles_from_reference(ts, vals, counts, "cpu")
    got = dr.rollup_aggregate_tile(func, aggr, *t, lay, cfg).numpy()
    assert np.isnan(got[0]).all()  # the empty group
    assert np.isfinite(got).sum() > 50
    _close(got, want, aggr, func)
    if aggr in ("count", "group", "min", "max"):
        # the chunks change no count or extremum of the unchunked walk
        unchunked = dr.aggregate_groups(aggr, dr.rollup_tile_plain(
            func, *t, cfg), lay.gids, G).numpy()
        np.testing.assert_array_equal(got, unchunked)


def test_chunks_fold_in_order(monkeypatch):
    """Chunk moments merge from the empty moments in chunk order: the
    earlier chunk's -0.0 wins a tie of extrema, as K2's fold keeps it."""
    monkeypatch.setattr(dr, "FLEET_CHUNK", 2)
    rolled = torch.tensor([[-0.0], [1.0], [0.0], [2.0], [5.0]],
                          dtype=torch.float64)
    lay = dr.group_layout(np.zeros(5, np.int32), 1, "cpu")
    assert lay.slots == 3
    m = dr.chunked_group_moments("min", rolled, lay)
    assert m["cnt"].item() == 5.0 and torch.signbit(m["min"]).item()
    s = dr.chunked_group_moments("sum", rolled, lay)
    assert s["s1"].item() == 8.0


# -- k2_plan ----------------------------------------------------------------

def _spans(ts, counts, T, step, lookback, steps):
    """The largest staged span of any row and step tile: the kernel's
    span_of on each row's samples."""
    worst = 0
    for t0 in range(0, T, steps):
        t1 = min(t0 + steps, T) - 1
        for r in range(ts.shape[0]):
            row = ts[r, :counts[r]].astype(np.int64)
            lo = np.searchsorted(row, t0 * step - lookback, side="right")
            hi = np.searchsorted(row, t1 * step, side="right")
            if hi > lo:
                worst = max(worst, hi - max(lo - 1, 0))
    return worst


def _rows(S, N, scrape, jitter, seed, keep=1.0):
    rng = np.random.default_rng(seed)
    ts = np.full((S, N), int(dr.TS_PAD), np.int64)
    counts = np.zeros(S, np.int32)
    for r in range(S):
        t = np.sort(np.arange(N) * scrape + rng.integers(-jitter, jitter + 1,
                                                         N))
        t = t[rng.random(N) < keep] if keep < 1 else t
        ts[r, :len(t)] = t
        counts[r] = len(t)
    return ts, counts


# (S, N, T, step, lookback, rows' scrape, keep): the dashboard, the full
# width, the full width's instant query, a 1 h step over 15 s scrapes,
# rows with gaps (a quarter of their samples), an int32-overflowing grid
PLANS = {
    "dashboard": (8192, 1440, 355, 60_000, 300_000, 15_000, 1.0),
    "full_width": (100_000, 5760, 5761, 15_000, 300_000, 15_000, 1.0),
    "instant": (100_000, 5760, 1, 15_000, 300_000, 15_000, 1.0),
    "step_1h": (8192, 5760, 24, 3_600_000, 300_000, 15_000, 1.0),
    "gappy": (8192, 1440, 355, 60_000, 300_000, 15_000, 0.25),
    "wrap": (64, 1440, 40_000, 60_000, 300_000, 15_000, 1.0),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_k2_plan(name):
    S, N, T, step, lookback, scrape, keep = PLANS[name]
    hint = dr.scrape_hint(N, T, step, lookback)
    plan = dr.k2_plan(S, N, T, step, lookback, hint, 132)
    if name in ("instant", "step_1h", "wrap"):
        # the span outgrows 96 KiB of stages (a lookback of 5760 columns'
        # worth, or 30,000 samples a tile), or the grid wraps
        assert plan == (dr.K2_GLOBAL, dr.K2_THREADS, 0, 0)
        return
    assert plan.path == dr.K2_STAGED
    assert plan.steps == {"dashboard": 128, "gappy": 128,
                          "full_width": 512}[name]
    assert plan.smem == 2 * (-(-4 * plan.cap // 16) * 16 +
                             2 * -(-8 * plan.cap // 16) * 16)
    assert plan.smem <= 96 << 10 and plan.cap <= N
    # every real row's span fits a stage (checked on 16 rows of the shape)
    ts, counts = _rows(16, N, scrape, 2000, 3, keep)
    assert _spans(ts, counts, min(T, 2 * plan.steps + 1), step, lookback,
                  plan.steps) <= plan.cap


# (S, N, T, step, lookback) of one time shard of B15's (2, 4) mesh over
# the full width's tile: half the rows, a quarter of the columns and the
# 32-column halo, a quarter of 1440 steps of 60 s
B15_SHARD = (50_000, 5760 // 4 + 32, 360, 60_000, 300_000)


@pytest.mark.parametrize("name", list(PLANS) + ["b15_shard"])
def test_b5_plan(name):
    if name == "b15_shard":
        S, N, T, step, lookback = B15_SHARD
    else:
        S, N, T, step, lookback = PLANS[name][:5]
    hint = dr.scrape_hint(N, T, step, lookback)
    plan = dr.b5_plan(S, N, T, step, lookback, hint, 132)
    if name in ("instant", "step_1h", "wrap"):
        assert plan == dr.B5_GLOBAL
        assert plan == (dr.K2_GLOBAL, 1, dr.K2_THREADS, 0, 0)
        return
    # the dashboard's 8192 rows in blocks of 32 keep 4 blocks an SM over
    # three 128-step tiles; the full width's and a B15 shard's 64-row
    # blocks take 512 steps (the shard's 360 in one tile)
    want = {"dashboard": (32, 128), "gappy": (32, 128),
            "full_width": (64, 512), "b15_shard": (64, 512)}[name]
    assert (plan.path, plan.rows, plan.steps) == (dr.K2_STAGED, *want)
    k2 = dr.k2_plan(-(-S // plan.rows) * dr._K2_BLOCK_ROWS, N, T, step,
                    lookback, hint, 132)
    # the tile, stages and path are K2's for S / rows blocks of rows
    assert (plan.steps, plan.cap, plan.smem) == k2[1:]
    blocks = -(-S // plan.rows) * -(-T // plan.steps)
    assert blocks >= 4 * 132 and plan.smem <= 96 << 10
    assert 8 <= plan.rows <= 64 and plan.cap <= N


def test_b5_plan_small_tiles_keep_the_card_busy():
    # a tile too small for 4 blocks an SM even at 8 rows a block stays
    # staged with the fewest rows
    plan = dr.b5_plan(256, 1440, 355, 60_000, 300_000,
                      dr.scrape_hint(1440, 355, 60_000, 300_000), 132)
    assert plan.path == dr.K2_STAGED and plan.rows == 8
    assert plan.steps == 128


# -- the staged window search against the reference's window bounds -------

def _count_le(a, lo, hi, x):
    while lo < hi:
        mid = (lo + hi) >> 1
        if a[mid] <= x:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _count_le_from(a, L, x, g):
    g = min(max(g, 0), L)
    if g < L and a[g] <= x:
        lo, hi, d = g + 1, L, 1
        while lo + d - 1 < L:
            p = lo + d - 1
            if a[p] > x:
                hi = p
                break
            lo, d = p + 1, 2 * d
    else:
        lo, hi, d = 0, g, 1
        while hi - d >= 0:
            p = hi - d
            if a[p] <= x:
                lo = p + 1
                break
            hi, d = p, 2 * d
    return _count_le(a, lo, hi, x)


def _guess(x, f0, per, L):
    d = (x - f0 + 2**31) % 2**32 - 2**31  # wsub: int32 arithmetic
    f = np.float32(np.float32(d) * per)
    if not f >= 0:
        return 0
    return L if f >= L else int(f) + 1


def _per(f0, f1, L):
    return np.float32(np.float32(L - 1) / np.float32(f1 - f0)) \
        if L > 1 and f1 > f0 else np.float32(0)


def _staged_bounds(ts, counts, T, step, lookback, steps, rows=None):
    """(lo, hi) [S, T] the way the kernel finds them: a step tile's span of
    each row from guesses on the row's ends, then each step's window
    inside the staged span.  rows=None walks the rows one at a time, as
    K2 walks a group's members; else in blocks of `rows` rows, B5's
    (each block's rows over each step tile)."""
    S = ts.shape[0]
    lo = np.zeros((S, T), np.int64)
    hi = np.zeros((S, T), np.int64)
    if rows is not None:
        for r0 in range(0, S, rows):
            sl = slice(r0, r0 + rows)
            lo[sl], hi[sl] = _staged_bounds(ts[sl], counts[sl], T, step,
                                            lookback, steps)
        return lo, hi
    for r in range(S):
        c = int(counts[r])
        row = [int(x) for x in ts[r, :c]]
        f0, f1 = (row[0], row[-1]) if c else (0, 0)
        per = _per(f0, f1, c)
        for t0 in range(0, T, steps):
            t1 = min(t0 + steps, T)
            lo_t0, grid1 = t0 * step - lookback, (t1 - 1) * step
            lo_first = _count_le_from(row, c, lo_t0, _guess(lo_t0, f0, per, c))
            hi_last = _count_le_from(row, c, grid1, _guess(grid1, f0, per, c))
            s0 = max(lo_first - 1, 0)
            span = row[s0:hi_last]
            n = len(span)
            if hi_last <= lo_first:  # every window empty
                lo[r, t0:t1] = hi[r, t0:t1] = lo_first
                continue
            g0 = span[0]
            sper = _per(g0, span[-1], n)
            for t in range(t0, t1):
                grid, lo_t = t * step, t * step - lookback
                h = _count_le_from(span, n, grid, _guess(grid, g0, sper, n))
                lo[r, t] = s0 + _count_le_from(span, h, lo_t,
                                               _guess(lo_t, g0, sper, h))
                hi[r, t] = s0 + h
    return lo, hi


def _window_rows(kind):
    rng = np.random.default_rng(23)
    if kind == "regular":
        return _rows(6, 400, 15_000, 0, 1)
    if kind == "jittered":
        return _rows(6, 400, 15_000, 7000, 2)
    if kind == "gappy":
        return _rows(6, 400, 15_000, 2000, 3, keep=0.1)
    ts = np.full((6, 400), int(dr.TS_PAD), np.int64)
    counts = np.zeros(6, np.int32)
    for r in range(6):
        if kind == "bursty":  # bursts of 1 s scrapes between long silences
            t = np.concatenate([b + np.arange(40) * 1000 for b in
                                np.sort(rng.choice(6_000, 8,
                                                   replace=False)) * 1000])
        else:  # duplicate timestamps, and a row starting before the grid
            t = np.repeat(np.arange(200) * 30_000 - 600_000, 2)
        t = np.sort(t)[:400]
        ts[r, :len(t)] = t
        counts[r] = len(t)
    return ts, counts


@pytest.mark.parametrize("walk,steps", [("k2", 128), ("k2", 512),
                                        ("b5", 128), ("b5", 512)])
@pytest.mark.parametrize("kind", ["regular", "jittered", "gappy", "bursty",
                                  "duplicates"])
def test_staged_search_finds_the_reference_windows(kind, walk, steps):
    ts, counts = _window_rows(kind)
    cfg = RollupConfig(0, 5_940_000, 15_000, 300_000)
    T = dr.num_steps(cfg)
    want_lo, want_hi, _ = ref._window_bounds(
        jnp.asarray(ts.astype(np.int32)), _ref_cfg(cfg))
    # B5's blocks of rows: 4 rows a block splits the 6 rows unevenly
    lo, hi = _staged_bounds(ts, counts, T, cfg.step, cfg.lookback, steps,
                            4 if walk == "b5" else None)
    live = np.asarray(want_hi) > np.asarray(want_lo)
    assert live.sum() > 100
    # the kernel reads lo and hi only where a window holds a sample
    np.testing.assert_array_equal(hi[live], np.asarray(want_hi)[live])
    np.testing.assert_array_equal(lo[live], np.asarray(want_lo)[live])
    np.testing.assert_array_equal(hi <= lo, ~live)
