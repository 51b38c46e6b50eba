"""K1 decode_tiles at its edge rows, and K3 append_tile and B10
fleet_append_tile at each lane grouping, through their plain PyTorch
versions on the CPU against the JAX package; the launch plans of the
three kernels (``k1_plan``, ``append_plan``); and csrc/decode.cu's chunked
arithmetic, replayed in numpy, against the plain decode.  Everything here
is bit for bit.

K1's edge rows: widths n of 1, 2, 3 and widths that are not a multiple of
4 or 16, d2 planes wider than n - 2 (the engine pads them to the tile
capacity), rows whose count is 0 (the mesh's padded rows, scale 1), and
linear tails that overflow int32, for each d2 plane width (int8, int16,
int32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from victoriametrics_tpu.ops import device_decode as ref_dd
from victoriametrics_tpu.ops import device_rollup as ref
from victoriametrics_tpu_torch import convert
from victoriametrics_tpu_torch.ops import device_decode as dd
from victoriametrics_tpu_torch.ops import device_rollup as dr

D2_TYPES = (np.int8, np.int16, np.int32)


def _edge_planes(rng, S: int, n: int, d2type, extra: int = 5):
    """S rows of n columns with random first values, first deltas and d2
    entries of `d2type`, the plane `extra` columns wider than n - 2; row 0
    has count 0 and scale 1, row 1 a tail that overflows int32, the rest
    counts in [0, n]."""
    info = np.iinfo(d2type)
    d2w = max(n - 2, 1) + extra
    lo, hi = max(int(info.min), -2**20), min(int(info.max), 2**20)
    ts_d2 = rng.integers(lo, hi + 1, (S, d2w)).astype(d2type)
    val_d2 = rng.integers(lo, hi + 1, (S, d2w)).astype(d2type)
    ts_first = rng.integers(-2**31, 2**31, S).astype(np.int32)
    ts_fd = rng.integers(-2**31, 2**31, S).astype(np.int32)
    val_first = rng.integers(-2**31, 2**31, S).astype(np.int32)
    val_fd = rng.integers(-2**31, 2**31, S).astype(np.int32)
    scale = 10.0 ** rng.integers(-6, 4, S).astype(np.float64)
    counts = rng.integers(0, n + 1, S).astype(np.int32)
    counts[0], scale[0] = 0, 1.0
    # a steep linear tail: 2e9 a column from 2e9 wraps at once
    ts_first[1] = val_first[1] = 2_000_000_000
    ts_fd[1] = val_fd[1] = 2_000_000_000
    ts_d2[1] = val_d2[1] = 0
    return (ts_first, ts_fd, ts_d2, val_first, val_fd, val_d2, scale,
            counts)


@pytest.mark.parametrize("d2type", D2_TYPES, ids=lambda t: t.__name__)
@pytest.mark.parametrize("n", [1, 2, 3, 13, 70, 257])
def test_decode_tiles_edge_rows_match_reference(n, d2type):
    rng = np.random.default_rng(1000 + n)
    fields = _edge_planes(rng, 12, n, d2type)
    want_ts, want_v = ref_dd.decode_tiles(*[jnp.asarray(a) for a in fields],
                                          n, np.float64)
    got_ts, got_v = dd.decode_tiles(
        *[torch.from_numpy(a.copy()) for a in fields], n)
    assert tuple(got_ts.shape) == (12, n)
    np.testing.assert_array_equal(got_ts.numpy(), np.asarray(want_ts))
    np.testing.assert_array_equal(got_v.numpy().view(np.uint64),
                                  np.asarray(want_v).view(np.uint64))
    assert (got_ts.numpy()[0] == dd.TS_PAD).all()  # count 0: all padding
    if n >= 2:
        assert got_v.numpy()[1, 1] < 0  # the tail wrapped


def _uint32_scan(x: np.ndarray) -> np.ndarray:
    return np.cumsum(x.astype(np.uint64)) & 0xFFFFFFFF


# threads a block of csrc/decode.cu's K1 (kK1Threads)
K1_THREADS = 256


def _kernel_plane(first: int, a: np.ndarray, n: int, chunk: int,
                  threads: int = K1_THREADS) -> np.ndarray:
    """csrc/decode.cu's decode of one plane of one row, replayed in uint32:
    chunks of `chunk` columns carrying b and x; in each, runs of odd length
    L a thread, their sums of a and of the running b, two block scans, and
    each run rebuilt from its start."""
    M = 0xFFFFFFFF
    a = a.astype(np.uint64)
    out = np.zeros(n, dtype=np.uint64)
    carry_b, carry_x = 0, int(first) & M
    for c0 in range(0, n, chunk):
        cols = min(chunk, n - c0)
        L = -(-cols // threads) | 1
        bounds = [(min(p * L, cols), min(min(p * L, cols) + L, cols))
                  for p in range(threads)]
        sa = np.array([int(a[c0 + i0:c0 + i1].sum()) & M
                       for i0, i1 in bounds], dtype=np.uint64)
        sb = np.array([int(_uint32_scan(a[c0 + i0:c0 + i1]).sum()) & M
                       for i0, i1 in bounds], dtype=np.uint64)
        ca = (carry_b + _uint32_scan(sa) - sa) & M
        seg = (np.array([i1 - i0 for i0, i1 in bounds], dtype=np.uint64)
               * ca + sb) & M
        cb = (carry_x + _uint32_scan(seg) - seg) & M
        for p, (i0, i1) in enumerate(bounds):
            b, x = int(ca[p]), int(cb[p])
            for i in range(i0, i1):
                b = (b + int(a[c0 + i])) & M
                x = (x + b) & M
                out[c0 + i] = x
        carry_b = (carry_b + int(sa.sum())) & M
        carry_x = (carry_x + int(seg.sum())) & M
    return out.astype(np.uint32).view(np.int32)


# runs of 1 column (chunks of up to 256), 3, 9 and 15 (7233 in two chunks)
@pytest.mark.parametrize("n,chunk", [
    (1, 1), (2, 2), (13, 5), (700, 96), (700, 700), (1857, 1856),
    (7233, 3616)])
def test_chunked_kernel_arithmetic_is_the_plain_decode(n, chunk):
    rng = np.random.default_rng(n + chunk)
    ts_first, ts_fd, ts_d2, *_ = _edge_planes(rng, 3, n, np.int32, extra=0)
    want = dd._reconstruct_plain(torch.from_numpy(ts_first),
                                 torch.from_numpy(ts_fd),
                                 torch.from_numpy(ts_d2), n).numpy()
    for r in range(3):
        a = np.zeros(n, dtype=np.int64)
        if n >= 2:
            a[1] = ts_fd[r]
        a[2:] = ts_d2[r, :n - 2]
        got = _kernel_plane(ts_first[r], a & 0xFFFFFFFF, n, chunk)
        np.testing.assert_array_equal(got, want[r])


# an A100's SM: 164 KB of shared memory
A100_SMEM = 167_936


@pytest.mark.parametrize("n,tb,vb,per_sm,want", [
    (1, 1, 1, dd.SMEM_PER_SM, 1),
    (3, 4, 4, dd.SMEM_PER_SM, 3),
    (1856, 2, 1, dd.SMEM_PER_SM, 1856),  # the dashboard: 28 KB, 8 an SM
    (7232, 2, 1, dd.SMEM_PER_SM, 7232),  # the full width: 108 KB, 2 an SM
    (7232, 2, 2, dd.SMEM_PER_SM, 3616),  # 16 B a column: two chunks
    (7232, 4, 4, dd.SMEM_PER_SM, 3616),
    (100_000, 1, 1, dd.SMEM_PER_SM, 7712),  # 13 chunks
    (7232, 2, 1, A100_SMEM, 3616),       # a smaller SM: two chunks
    (100_000, 1, 1, A100_SMEM, 5888),    # 17 chunks
])
def test_k1_plan_chunks_by_width_and_shared_memory(n, tb, vb, per_sm, want):
    plan = dd.k1_plan(n, tb, vb, per_sm)
    assert plan.chunk == want
    assert plan.smem == dd.k1_smem(plan.chunk, tb, vb)
    room = per_sm // 2 - dd.SMEM_RESERVED - dd.K1_STATIC_SMEM
    assert plan.smem <= room  # two blocks an SM
    if plan.chunk < n:  # the fewest chunks that fit, of equal width
        chunks = -(-n // plan.chunk)
        assert plan.chunk % 32 == 0 and plan.chunk * chunks - n < 32 * chunks
        assert dd.k1_smem(-(-n // (chunks - 1)), tb, vb) > room


def test_append_plan_groups_lanes_by_k():
    # the least power of two >= K / 2, at least 4 and at most a warp: 4
    # lanes at the K of 8 that refreshes and steady fleet intervals pad to,
    # 8 and 16 at K 16 and 24, a warp at 120
    got = {K: dr.append_plan(K) for K in
           (0, 1, 2, 3, 4, 5, 8, 9, 16, 17, 24, 64, 65, 120, 1000)}
    assert got == {0: 4, 1: 4, 2: 4, 3: 4, 4: 4, 5: 4, 8: 4, 9: 8, 16: 8,
                   17: 16, 24: 16, 64: 32, 65: 32, 120: 32, 1000: 32}


def _append_case(rng, rows: int, N: int, K: int):
    """A tile of `rows` rows with counts at, near and below the capacity
    and new_counts 0, K and between."""
    ts = rng.integers(0, 10**6, (rows, N)).astype(np.int32)
    vals = rng.normal(0, 1e3, (rows, N))
    counts = rng.integers(0, N + 1, rows).astype(np.int32)
    counts[:6] = [N, N - 1, N - 3, max(N - K, 0), 0, N - K // 2]
    new_ts = rng.integers(10**6, 2 * 10**6, (rows, K)).astype(np.int32)
    new_vals = rng.normal(0, 1e3, (rows, K))
    new_vals[0, 0] = -0.0
    new_counts = rng.integers(0, K + 1, rows).astype(np.int32)
    new_counts[::5] = 0
    new_counts[1::5] = K
    return ts, vals, counts, new_ts, new_vals, new_counts


def _same_bits(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint8),
                                      np.asarray(w).view(np.uint8))


@pytest.mark.parametrize("K", [1, 8, 16, 24, 120])
def test_append_tile_lane_groups_match_reference(K):
    rng = np.random.default_rng(K)
    case = _append_case(rng, 40, 256, K)
    want = ref.append_tile(*[jnp.asarray(a) for a in case])
    t = convert.tiles_from_reference(*case[:3], "cpu")
    got = dr.append_tile(*t, *[torch.from_numpy(a) for a in case[3:]])
    assert all(g is o for g, o in zip(got, t))  # in place
    _same_bits(got, want)


@pytest.mark.parametrize("K", [1, 8, 16, 24, 120])
def test_fleet_append_tile_lane_groups_match_reference(K):
    rng = np.random.default_rng(100 + K)
    B, S, N = 3, 16, 256
    case = [a.reshape((B, S) + a.shape[1:])
            for a in _append_case(rng, B * S, N, K)]
    case[5][1] = 0  # nothing staged for slot 1
    want = ref.fleet_append_tile(*[jnp.asarray(a) for a in case])
    t = convert.tiles_from_reference(*case[:3], "cpu")
    got = dr.fleet_append_tile(*t, *[torch.from_numpy(a) for a in case[3:]])
    assert all(g is o for g, o in zip(got, t))  # in place
    _same_bits(got, want)
