"""Port parity: the native host codec (victoriametrics_tpu_torch/native,
codec.cpp with parse.cpp and ingest.cpp built by g++ on first use) against
the JAX package's native codec and the port's own numpy paths, on the same
seeded inputs; the library's name covers every source.

Mirrors tests/test_f2d_native.py (its CASES and random group starts):
the grouped float -> decimal bit for bit, native and numpy; then every
other binding of codec.cpp against the reference's binding.  The tests
skip only where g++ is missing, as the reference's requires_native does;
a failed build with g++ present fails them."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from test_f2d_native import CASES, _random_starts
from victoriametrics_tpu import native as ref_native
from victoriametrics_tpu.ops import decimal as ref_dec
from victoriametrics_tpu_torch import native
from victoriametrics_tpu_torch.ops import decimal as dec

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="needs g++ to build the native codec")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _built():
    assert native.available(), "g++ is present but the codec did not load"
    if not ref_native.available():
        pytest.skip("the reference's native codec did not build")


def _python_grouped(v, starts, monkeypatch):
    """The port's grouped conversion with the native twin switched off."""
    monkeypatch.setattr(native, "f2d_grouped", lambda *a: None)
    try:
        return dec.float_to_decimal_grouped(v, starts)
    finally:
        monkeypatch.undo()


def _specials_and_edges(rng):
    sp = rng.uniform(0, 100, 1000)
    sp[::7] = np.nan
    sp[1::13] = np.inf
    sp[2::17] = -np.inf
    sp[3::19] = dec.STALE_NAN
    sp[4::23] = 0.0
    edges = np.array([1e-3, 1e3, 0.001, 1000.0, 2 / 3, 1 / 3, 0.1, 0.2,
                      0.3, 123.456, 1e17, -1e17, 9.999999999999999e16,
                      5e-324, 1e-320, 1e-310, 2.2e-308, 1.7e308, -1.7e308])
    return {"specials": sp, "edges": edges}


def _f2d_inputs():
    out = []
    for case in sorted(CASES):
        rng = np.random.default_rng(hash(case) % 2 ** 31)
        v = CASES[case](rng)
        out.append((case, v, _random_starts(rng, v.size)))
    rng = np.random.default_rng(99)
    for case, v in _specials_and_edges(rng).items():
        out.append((case, v, _random_starts(rng, v.size)))
    return out


F2D = {case: (v, starts) for case, v, starts in _f2d_inputs()}


@pytest.mark.parametrize("case", sorted(F2D))
def test_f2d_grouped_matches_reference_native_and_numpy(case, monkeypatch):
    v, starts = F2D[case]
    m_c, e_c = native.f2d_grouped(v, starts)
    m_r, e_r = ref_native.f2d_grouped(v, starts)
    m_py, e_py = _python_grouped(v, starts, monkeypatch)
    for m, e in ((m_r, e_r), (m_py, e_py),
                 ref_dec.float_to_decimal_grouped(v, starts)):
        np.testing.assert_array_equal(m_c, m, err_msg=case)
        np.testing.assert_array_equal(e_c, e, err_msg=case)
    assert m_c.dtype == np.int64 and e_c.dtype == np.int64


def test_grouped_dispatch_uses_native(monkeypatch):
    """float_to_decimal_grouped dispatches to the native twin from 256
    values on and agrees with the forced-numpy path there."""
    rng = np.random.default_rng(3)
    v = np.round(rng.uniform(-10, 10, 2048), 2)
    starts = _random_starts(rng, v.size)
    calls = []
    real = native.f2d_grouped
    monkeypatch.setattr(native, "f2d_grouped",
                        lambda *a: calls.append(1) or real(*a))
    m_d, e_d = dec.float_to_decimal_grouped(v, starts)
    assert calls == [1]
    dec.float_to_decimal_grouped(v[:255], starts[starts < 255])
    assert calls == [1]  # below 256 values: numpy
    monkeypatch.undo()
    m_py, e_py = _python_grouped(v, starts, monkeypatch)
    np.testing.assert_array_equal(m_d, m_py)
    np.testing.assert_array_equal(e_d, e_py)


def test_varint_and_delta_codecs_match_reference():
    rng = np.random.default_rng(9)
    for size in (1, 2, 5, 1000, 8192):
        v = rng.integers(-(1 << 55), 1 << 55, size, dtype=np.int64)
        data = native.varint_encode(v)
        assert data == ref_native.varint_encode(v)
        np.testing.assert_array_equal(native.varint_decode(data, size), v)
    for v in (np.cumsum(rng.integers(0, 100, 5000)).astype(np.int64),
              rng.integers(-500, 500, 3000).astype(np.int64)):
        got = native.delta2_encode(v)
        assert got == ref_native.delta2_encode(v)
        np.testing.assert_array_equal(native.delta2_decode(*got, v.size), v)
        got = native.delta_encode(v)
        assert got == ref_native.delta_encode(v)
        np.testing.assert_array_equal(native.delta_decode(*got, v.size), v)
    with pytest.raises(ValueError):
        native.varint_decode(b"\x81" * 12, 1)
    with pytest.raises(ValueError):
        native.delta2_decode(b"\x81", 0, 1, 5)


def test_zstd_one_shots_match_reference():
    assert native.has_zstd() == ref_native.has_zstd()
    assert native.decompress_caps() == ref_native.decompress_caps()
    if not native.has_zstd():
        pytest.skip("no zstd library on this host")
    data = np.cumsum(np.arange(20_000) % 7).astype(np.int64).tobytes()
    packed = native.zstd_compress(data, 1)
    assert packed == ref_native.zstd_compress(data, 1)
    assert native.zstd_decompress(packed) == data
    with pytest.raises(ValueError):
        native.zstd_decompress(packed, max_size=len(data) - 1)


def _blocks(rng, k=12):
    """k blocks of counters, gauges, constant and arithmetic runs (every
    marshal type), concatenated, with their K + 1 offsets."""
    parts = []
    for i in range(k):
        n = int(rng.integers(1, 400))
        kind = i % 4
        if kind == 0:
            b = np.cumsum(rng.integers(0, 100, n))
        elif kind == 1:
            b = rng.integers(-500, 500, n)
        elif kind == 2:
            b = np.full(n, int(rng.integers(-9, 9)))
        else:
            b = 1_700_000_000_000 + np.arange(n) * 15_000
        parts.append(b.astype(np.int64))
    offs = np.concatenate([[0], np.cumsum([p.size for p in parts])])
    return np.concatenate(parts), offs.astype(np.int64)


def _marshalled(lib, vals, offs):
    payload, types, firsts, lens = lib.marshal_i64_many(vals, offs)
    return payload, types, firsts, lens, np.concatenate(
        [[0], np.cumsum(lens)[:-1]]).astype(np.int64)


def test_block_marshal_and_decode_match_reference():
    rng = np.random.default_rng(11)
    vals, offs = _blocks(rng)
    got = native.marshal_i64_many(vals, offs)
    want = ref_native.marshal_i64_many(vals, offs)
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)
    payload, types, firsts, lens, starts = _marshalled(native, vals, offs)
    cnt = np.diff(offs)
    for validate in (False, True):
        out, ref_out = np.empty(vals.size, np.int64), np.empty(vals.size,
                                                               np.int64)
        native.decode_blocks(payload, starts, lens, types, firsts, cnt, out,
                             validate)
        ref_native.decode_blocks(payload, starts, lens, types, firsts, cnt,
                                 ref_out, validate)
        np.testing.assert_array_equal(out, ref_out)
        if not validate:  # validation clamps non-monotonic (gauge) blocks
            np.testing.assert_array_equal(out, vals)


def test_assemble_part_matches_reference():
    rng = np.random.default_rng(12)
    k = 10
    cnt = rng.integers(1, 300, k).astype(np.int64)
    ts = np.concatenate([1_700_000_000_000 + np.sort(
        rng.integers(0, 10**7, n)) for n in cnt]).astype(np.int64)
    mants = np.concatenate([np.cumsum(rng.integers(0, 50, n))
                            for n in cnt]).astype(np.int64)
    offs = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int64)
    exps = rng.integers(-4, 2, k).astype(np.int64)
    tp, tt, tf, tl, to = _marshalled(native, ts, offs)
    vp, vt, vf, vl, vo = _marshalled(native, mants, offs)
    lo, hi = 1_700_000_000_000 + 2 * 10**6, 1_700_000_000_000 + 7 * 10**6
    args = (tp, vp, to, tl, tt, tf, vo, vl, vt, vf, cnt, exps, lo, hi)
    got, want = native.assemble_part(*args), ref_native.assemble_part(*args)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.view(np.int64), b.view(np.int64))
    keep = (ts >= lo) & (ts <= hi)
    np.testing.assert_array_equal(got[1], ts[keep])
    assert int(got[0].sum()) == int(keep.sum())


def test_decimal_to_float_blocks_match_reference_and_numpy():
    rng = np.random.default_rng(13)
    cnt = rng.integers(1, 500, 40)
    goff = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int64)
    mants = rng.integers(-10**15, 10**15, int(goff[-1])).astype(np.int64)
    mants[::97] = dec.V_STALE_NAN
    mants[1::101] = dec.V_INF_NEG
    scales = rng.integers(-20, 5, cnt.size).astype(np.int64)
    outs = [np.empty(mants.size) for _ in range(3)]
    native.decimal_to_float_blocks(mants, goff, scales, outs[0])
    ref_native.decimal_to_float_blocks(mants, goff, scales, outs[1])
    dec.decimal_to_float_blocks_py(mants, goff, scales, outs[2])
    for o in outs[1:]:
        np.testing.assert_array_equal(outs[0].view(np.uint64),
                                      o.view(np.uint64))


def _padded(rng, S=6, N=40):
    cnt = rng.integers(1, N + 1, S).astype(np.int64)
    ts2 = np.full((S, N), 2**62, np.int64)
    v2 = np.zeros((S, N))
    for i, n in enumerate(cnt):
        ts2[i, :n] = 1_000_000 + np.sort(rng.integers(0, 600_000, n))
        v2[i, :n] = np.cumsum(rng.integers(0, 9, n)).astype(np.float64)
    return ts2, v2, cnt


def test_row_kernels_match_reference():
    """clip_blocks, gather_rows2, scatter_pad, dedup_rows and
    counter_resets_2d on the same inputs as the reference's binding."""
    rng = np.random.default_rng(14)
    bcnt = rng.integers(1, 50, 9)
    bend = np.cumsum(bcnt).astype(np.int64)
    bstart = bend - bcnt
    ts = np.concatenate([np.sort(rng.integers(0, 1000, n))
                         for n in bcnt]).astype(np.int64)
    keep_lo, keep_hi = native.clip_blocks(ts, bstart, bend, 200, 700)
    for a, b in zip((keep_lo, keep_hi),
                    ref_native.clip_blocks(ts, bstart, bend, 200, 700)):
        np.testing.assert_array_equal(a, b)
    total = int((keep_hi - keep_lo).sum())
    other = rng.integers(0, 99, ts.size).astype(np.int64)
    for a, b in zip(native.gather_rows2(ts, other, keep_lo, keep_hi, total),
                    ref_native.gather_rows2(ts, other, keep_lo, keep_hi,
                                            total)):
        np.testing.assert_array_equal(a, b)
    vals = rng.uniform(0, 9, ts.size)
    rows = np.array([0, 2, 1, 0, 3, 2, 1, 3, 0], np.int64)
    for a, b in zip(native.scatter_pad(ts, vals, bcnt.astype(np.int64), rows,
                                       4, 120, 2**62),
                    ref_native.scatter_pad(ts, vals, bcnt.astype(np.int64),
                                           rows, 4, 120, 2**62)):
        np.testing.assert_array_equal(a.view(np.int64), b.view(np.int64))
    ts2, v2, cnt = _padded(rng)
    v2[1, 3] = dec.STALE_NAN
    ts2[2, 5] = ts2[2, 4]  # an exact duplicate timestamp
    for interval in (0, 30_000):
        runs = []
        for lib in (native, ref_native):
            t, v, c = ts2.copy(), v2.copy(), cnt.copy()
            lib.dedup_rows(t, v, c, np.arange(6, dtype=np.int64), interval,
                           2**62)
            runs.append((t.tobytes(), v.tobytes(), c.tobytes()))
        assert runs[0] == runs[1]
    resets = v2.copy()
    resets[:, 10:] -= 20.0
    np.testing.assert_array_equal(native.counter_resets_2d(resets),
                                  ref_native.counter_resets_2d(resets))


@pytest.mark.parametrize("func", sorted(native.ROLLUP_COUNTER_FUNCS))
def test_rollup_counter_2d_matches_reference(func):
    rng = np.random.default_rng(15)
    ts2, v2, cnt = _padded(rng, S=8, N=60)
    v2[3, 20:] -= 15.0  # a counter reset
    mpi = rng.integers(0, 40_000, 8).astype(np.int64)
    args = (func, ts2, v2, cnt, 1_060_000, 1_600_000, 30_000, 120_000, mpi)
    got = native.rollup_counter_2d(*args)
    want = ref_native.rollup_counter_2d(*args)
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))


BUILD_RACE = r"""
import sys
from pathlib import Path
from victoriametrics_tpu_torch import native
native.BUILD_DIR = Path(sys.argv[1])
import numpy as np
m, e = native.f2d_grouped(np.array([1.5, 2.25] * 200), np.array([0, 200]))
print("OK", int(m[0]), [int(x) for x in e])
"""


def test_concurrent_first_loads_build_once(tmp_path):
    """Processes that load at once (test workers) build one library: the
    others wait on the lock and load it; no temporary file is left."""
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_RACE,
                               str(tmp_path)], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-2000:]
        assert "OK 150 [-2, -2]" in out, out
    names = sorted(p.name for p in tmp_path.iterdir())
    assert [n for n in names if n.endswith(".so")] == \
        [native.library_path().name]
    assert not [n for n in names if n.endswith(".tmp")]


@pytest.mark.parametrize("changed", ["codec.cpp", "parse.cpp", "ingest.cpp"])
def test_library_digest_covers_every_source(tmp_path, monkeypatch, changed):
    """The library is named by a digest of all three sources: a change to
    any one of them names another library (so a build from older sources
    is never loaded), and unchanged sources name the same one."""
    assert [p.name for p in native.SOURCES] == \
        ["codec.cpp", "parse.cpp", "ingest.cpp"]
    copies = []
    for src in native.SOURCES:
        dst = tmp_path / src.name
        dst.write_bytes(src.read_bytes())
        copies.append(dst)
    monkeypatch.setattr(native, "SOURCES", tuple(copies))
    before = native.library_path()
    assert before.name == native.library_path().name
    target = tmp_path / changed
    target.write_bytes(target.read_bytes() + b"\n// changed\n")
    after = native.library_path()
    assert after.name != before.name
    assert after.parent == before.parent == native.BUILD_DIR
    # moving bytes from one source to the next is a change too
    target.write_bytes(target.read_bytes()[:-len(b"\n// changed\n")])
    assert native.library_path().name == before.name
    first, second = copies[0], copies[1]
    tail = first.read_bytes()[-1:]
    first.write_bytes(first.read_bytes()[:-1])
    second.write_bytes(tail + second.read_bytes())
    assert native.library_path().name != before.name
