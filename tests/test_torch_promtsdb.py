"""The port's Prometheus TSDB block reader and writer
(``victoriametrics_tpu_torch/utils/promtsdb.py``) and vmctl's
prometheus-tsdb mode against the reference's.

Every case of ``tests/test_promtsdb.py`` is written once and run on both
packages through the ``pkg`` fixture (``ref`` = the JAX package, ``port``
= victoriametrics_tpu_torch); the port's run also runs the reference's
and holds the two results equal: the XOR chunks' bytes, the blocks'
files, the verify reports and the migrated columns.  Then the port's own
cases: ``write_block`` gives byte-identical files in both packages for the
same seeded series, and each package reads the other's block to the same
arrays (a user's Prometheus data directory is the input, so the format is
the reference's to the byte)."""

import hashlib
import os
import struct
import time
import types

import numpy as np
import pytest

from victoriametrics_tpu.utils import promtsdb as ref_pt
from victoriametrics_tpu_torch.utils import promtsdb as port_pt

DAY = 86_400_000
#: a day-aligned anchor two days back: inside the default retention
T0 = (int(time.time() * 1000) - 2 * DAY) // DAY * DAY
#: the migration's block: the last hour (recent, so retention keeps it)
T_HOUR = int(time.time() * 1000) - 3_600_000


def _package(name: str):
    if name == "ref":
        from victoriametrics_tpu.apps import vmctl
        from victoriametrics_tpu.httpapi.prometheus_api import PrometheusAPI
        from victoriametrics_tpu.httpapi.server import HTTPServer
        from victoriametrics_tpu.storage.storage import Storage
        from victoriametrics_tpu.storage.tag_filters import filters_from_dict
        pt = ref_pt
    else:
        from victoriametrics_tpu_torch.apps import vmctl
        from victoriametrics_tpu_torch.httpapi.prometheus_api import \
            PrometheusAPI
        from victoriametrics_tpu_torch.httpapi.server import HTTPServer
        from victoriametrics_tpu_torch.storage.storage import Storage
        from victoriametrics_tpu_torch.storage.tag_filters import \
            filters_from_dict
        pt = port_pt
    return types.SimpleNamespace(
        name=name, pt=pt, vmctl=vmctl, PrometheusAPI=PrometheusAPI,
        HTTPServer=HTTPServer, Storage=Storage,
        filters_from_dict=filters_from_dict)


REF, PORT = _package("ref"), _package("port")


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    return REF if request.param == "ref" else PORT


def both(case, pkg, tmp_path, *args):
    """Run ``case`` on the package; on the port also on the reference,
    the two results equal."""
    got = case(pkg, tmp_path / pkg.name, *args)
    if pkg is PORT:
        want = case(REF, tmp_path / "ref", *args)
        assert _same(got, want)
    return got


def _same(a, b) -> bool:
    """Equal results, arrays bit for bit."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and \
            a.tobytes() == b.tobytes()
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b


def _mk_series(rng, n_series=6, t0=T0):
    out = []
    for i in range(n_series):
        n = int(rng.integers(1, 500))
        ts = np.cumsum(rng.integers(1, 30_000, n)) + t0
        kind = i % 3
        if kind == 0:
            vals = np.cumsum(rng.integers(0, 50, n)).astype(np.float64)
        elif kind == 1:
            vals = np.round(rng.uniform(-1000, 1000, n), 3)
        else:
            vals = rng.standard_normal(n) * 10.0 ** float(rng.integers(-5, 5))
        out.append(({"__name__": f"pm{i}", "job": "tsdb",
                     "idx": str(i)}, ts, vals))
    return out


def _report(rep: dict) -> dict:
    """A verify report without its block path (each run has its own)."""
    return {k: v for k, v in rep.items() if k != "path"}


def _block_files(blk: str) -> dict:
    """Each file of a block directory by its path: its sha256."""
    out = {}
    for dp, _, fns in os.walk(blk):
        for fn in fns:
            full = os.path.join(dp, fn)
            with open(full, "rb") as f:
                out[os.path.relpath(full, blk)] = \
                    hashlib.sha256(f.read()).hexdigest()
    return out


# -- XOR chunks ----------------------------------------------------------------

def _roundtrip(P, ts, vals):
    data = P.pt.encode_xor_chunk(ts, vals)
    ts2, v2 = P.pt.decode_xor_chunk(data)
    np.testing.assert_array_equal(ts, ts2)
    np.testing.assert_array_equal(np.asarray(vals).view(np.uint64),
                                  v2.view(np.uint64))
    return data, ts2, v2


def _xor_random(P, tmp, seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 2000))
    ts = np.cumsum(rng.integers(1, 100_000, n)) + T0
    return _roundtrip(P, ts, rng.standard_normal(n))


def _xor_regular_scrape(P, tmp):
    # constant 15 s interval: the dod == 0 single-bit path
    ts = T0 + np.arange(1000, dtype=np.int64) * 15_000
    out = _roundtrip(P, ts, np.full(1000, 42.5))
    assert len(out[0]) < 300  # ~2 bits/sample: dod=0 + repeat-value
    return out


def _xor_special_values(P, tmp):
    ts = T0 + np.arange(6, dtype=np.int64) * 1000
    return _roundtrip(P, ts, np.array([0.0, np.inf, -np.inf, np.nan,
                                       1e-300, -0.0]))


def _xor_large_dod(P, tmp):
    # every dod prefix class, the 64-bit escape too
    deltas = [1000, 1000, 9000, 70_000, 600_000, 10 ** 10]
    ts = np.cumsum([T0] + deltas).astype(np.int64)
    return _roundtrip(P, ts, np.arange(len(ts), dtype=np.float64))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_xor_roundtrip_random(pkg, tmp_path, seed):
    both(_xor_random, pkg, tmp_path, seed)


@pytest.mark.parametrize("case", [_xor_regular_scrape, _xor_special_values,
                                  _xor_large_dod],
                         ids=["regular_scrape", "special_values",
                              "large_dod"])
def test_xor_roundtrip(pkg, tmp_path, case):
    both(case, pkg, tmp_path)


def test_crc32c_and_varints(pkg):
    """CRC32C (slicing-by-8 and the byte loop) against the standard check
    value and the reference; uvarint/varint round trips."""
    pt = pkg.pt
    assert pt.crc32c(b"123456789") == 0xE3069283
    rng = np.random.default_rng(4)
    for n in (0, 1, 7, 8, 9, 63, 64, 1000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert pt.crc32c(data) == ref_pt.crc32c(data)
    for x in (0, 1, 127, 128, 300, 2 ** 35, 2 ** 63 - 1):
        b = pt._put_uvarint(x)
        assert b == ref_pt._put_uvarint(x) and pt._uvarint(b, 0) == \
            (x, len(b))
    for x in (0, -1, 1, -64, 64, -(2 ** 40), 2 ** 40):
        b = pt._put_varint(x)
        assert b == ref_pt._put_varint(x) and pt._varint(b, 0) == \
            (x, len(b))


# -- blocks --------------------------------------------------------------------

def _write_read_verify(P, tmp):
    series = _mk_series(np.random.default_rng(0))
    blk = str(tmp / "b1")
    P.pt.write_block(blk, series)
    got = {tuple(sorted(lb.items())): (t, v)
           for lb, t, v in P.pt.read_block(blk, verify_crc=True)}
    assert len(got) == len(series)
    for labels, ts, vals in series:
        t2, v2 = got[tuple(sorted(labels.items()))]
        np.testing.assert_array_equal(np.asarray(ts, np.int64), t2)
        np.testing.assert_array_equal(vals, v2)
    rep = P.pt.verify_block(blk)
    assert rep["ok"], rep["errors"]
    assert rep["series"] == len(series)
    assert rep["samples"] == sum(len(t) for _, t, _ in series)
    return _report(rep), _block_files(blk), sorted(got.items())


def _chunk_corruption(P, tmp):
    blk = str(tmp / "b2")
    P.pt.write_block(blk, _mk_series(np.random.default_rng(1), 3))
    p = os.path.join(blk, "chunks", "000001")
    data = bytearray(open(p, "rb").read())
    data[30] ^= 0xFF
    open(p, "wb").write(bytes(data))
    rep = P.pt.verify_block(blk)
    assert not rep["ok"]
    assert any("crc" in e or "chunk" in e for e in rep["errors"])
    return _report(rep)


def _index_corruption(P, tmp):
    blk = str(tmp / "b4")
    P.pt.write_block(blk, _mk_series(np.random.default_rng(2), 3))
    p = os.path.join(blk, "index")
    data = bytearray(open(p, "rb").read())
    # a byte inside the series section (after the symbol table)
    data[P.pt.TSDBBlock(blk)._toc["series"] + 3] ^= 0xFF
    open(p, "wb").write(bytes(data))
    rep = P.pt.verify_block(blk)
    assert not rep["ok"]
    assert any("crc" in e or "index" in e for e in rep["errors"])
    return _report(rep)


def _unsupported_encoding(P, tmp):
    blk = str(tmp / "b5")
    P.pt.write_block(blk, _mk_series(np.random.default_rng(3), 3))
    # one chunk's encoding byte rewritten to 2 (a native histogram), its
    # crc fixed up so only the encoding is unsupported
    p = os.path.join(blk, "chunks", "000001")
    seg = bytearray(open(p, "rb").read())
    ln, i = P.pt._uvarint(seg, 8)
    seg[i] = 2
    body = bytes(seg[i:i + 1 + ln])
    seg[i + 1 + ln:i + 1 + ln + 4] = struct.pack(">I", P.pt.crc32c(body))
    open(p, "wb").write(bytes(seg))
    skipped = []
    got = list(P.pt.read_block(
        blk, on_unsupported=lambda lb, e: skipped.append((lb, str(e)))))
    assert len(skipped) == 1
    assert len(got) == 2
    return skipped, got


def _bad_magic(P, tmp):
    blk = tmp / "b3"
    (blk / "chunks").mkdir(parents=True)
    (blk / "index").write_bytes(struct.pack(">IB", 0xDEAD, 2))
    (blk / "chunks" / "000001").write_bytes(b"\x00" * 8)
    rep = P.pt.verify_block(str(blk))
    assert not rep["ok"]
    return _report(rep)


@pytest.mark.parametrize("case", [_write_read_verify, _chunk_corruption,
                                  _index_corruption, _unsupported_encoding,
                                  _bad_magic],
                         ids=["write_read_verify", "chunk_corruption",
                              "index_corruption", "unsupported_encoding",
                              "bad_magic"])
def test_block(pkg, tmp_path, case):
    both(case, pkg, tmp_path)


# -- vmctl prometheus-tsdb -----------------------------------------------------

def _migration(P, tmp):
    """A block into vmsingle through vmctl's prometheus_tsdb: every
    sample, the values exactly (the text round trip is repr)."""
    rng = np.random.default_rng(5)
    series = []
    for i in range(4):
        ts = T_HOUR + np.arange(50, dtype=np.int64) * 15_000
        vals = np.round(rng.uniform(0, 100, 50), 2)
        series.append(({"__name__": "mig", "idx": str(i)}, ts, vals))
    P.pt.write_block(str(tmp / "tsdb" / "01ABCDEF"), series)
    storage = P.Storage(str(tmp / "vm"))
    api = P.PrometheusAPI(storage, None)
    srv = P.HTTPServer("127.0.0.1", 0)
    api.register(srv)
    srv.start()
    try:
        n = P.vmctl.prometheus_tsdb(str(tmp / "tsdb"),
                                    f"http://127.0.0.1:{srv.port}",
                                    chunk_lines=64)
        assert n == 200
        cols = storage.search_columns(
            P.filters_from_dict({"__name__": "mig"}), 0, 1 << 62)
        assert cols.n_series == 4 and cols.n_samples == 200
        by_raw = {cols.raw_names[i]: (cols.ts[i, :cols.counts[i]],
                                      cols.vals[i, :cols.counts[i]])
                  for i in range(4)}
        out = []
        for labels, ts, vals in series:
            raw = [r for r in by_raw
                   if f'idx\x01{labels["idx"]}'.encode() in r]
            assert len(raw) == 1
            np.testing.assert_array_equal(by_raw[raw[0]][0], ts)
            np.testing.assert_array_equal(by_raw[raw[0]][1], vals)
            out.append(by_raw[raw[0]])
    finally:
        srv.stop()
        storage.close()
    with pytest.raises(SystemExit, match="no blocks"):
        P.vmctl.prometheus_tsdb(str(tmp / "vm"), "http://127.0.0.1:9")
    return n, out


def test_block_to_vmsingle(pkg, tmp_path):
    both(_migration, pkg, tmp_path)


# -- the port's own: the reference's format to the byte ------------------------

@pytest.mark.parametrize("seed", [0, 11, 12])
def test_write_block_byte_identical(tmp_path, seed):
    """The same seeded series give the same files, byte for byte, from both
    packages' write_block (index, chunks and meta.json)."""
    series = _mk_series(np.random.default_rng(seed), 9)
    series.append(({"__name__": "edge", "job": "tsdb", "idx": "s"},
                   T0 + np.arange(3, dtype=np.int64) * 15_000,
                   np.array([np.nan, np.inf, -0.0])))
    port_pt.write_block(str(tmp_path / "port"), series)
    ref_pt.write_block(str(tmp_path / "ref"), series)
    got, want = (_block_files(str(tmp_path / d)) for d in ("port", "ref"))
    assert got == want and {"index", "meta.json",
                            os.path.join("chunks", "000001")} <= set(got)


def _read_all(pt, blk):
    return sorted((sorted(lb.items()), ts, vals)
                  for lb, ts, vals in pt.read_block(blk, verify_crc=True))


def test_each_package_reads_the_others_block(tmp_path):
    """A block written by either package reads back through the other
    to the same labels and arrays (bit for bit), and verifies in both."""
    series = _mk_series(np.random.default_rng(13), 12)
    for name, writer in (("port", port_pt), ("ref", ref_pt)):
        blk = str(tmp_path / name)
        writer.write_block(blk, series)
        by_port, by_ref = _read_all(port_pt, blk), _read_all(ref_pt, blk)
        assert _same(by_port, by_ref) and len(by_port) == 12
        assert port_pt.verify_block(blk) == ref_pt.verify_block(blk)
        assert port_pt.verify_block(blk)["path"] == blk
        assert port_pt.verify_block(blk)["ok"]
