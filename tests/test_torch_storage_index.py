"""The port's index layer against the JAX package's on the CPU: the native
codec's xxh64/xxh32 against the ``xxhash`` package, TSID generation and
marshaling, MetricName and TagFilter, the mergeset table (item searches,
flush, merge, cross-reading its parts) and IndexDB (tag-filter searches
over the same metric names and ids, in both directions of on-disk
reading), dedup and the block codec."""

import os
import shutil

import numpy as np
import pytest
import xxhash

from victoriametrics_tpu.ops import decimal as ref_dec
from victoriametrics_tpu.storage import block as ref_block
from victoriametrics_tpu.storage import dedup as ref_dedup
from victoriametrics_tpu.storage import index_db as ref_idb
from victoriametrics_tpu.storage import mergeset as ref_ms
from victoriametrics_tpu.storage import metric_name as ref_mn
from victoriametrics_tpu.storage import tag_filters as ref_tf
from victoriametrics_tpu.storage import tsid as ref_tsid
from victoriametrics_tpu_torch import native
from victoriametrics_tpu_torch.storage import block as port_block
from victoriametrics_tpu_torch.storage import dedup as port_dedup
from victoriametrics_tpu_torch.storage import index_db as port_idb
from victoriametrics_tpu_torch.storage import mergeset as port_ms
from victoriametrics_tpu_torch.storage import metric_name as port_mn
from victoriametrics_tpu_torch.storage import tag_filters as port_tf
from victoriametrics_tpu_torch.storage import tsid as port_tsid

MODS = {"ref": (ref_ms, ref_idb, ref_mn, ref_tf, ref_tsid),
        "port": (port_ms, port_idb, port_mn, port_tf, port_tsid)}


@pytest.mark.parametrize("n", [0, 1, 3, 4, 7, 8, 15, 16, 17, 31, 32, 33,
                               63, 64, 100, 1000, 4099])
def test_xxhash_digests_match_the_package(n):
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    for seed in (0, 1, 0x9E3779B1):
        assert native.xxh64(data, seed) == xxhash.xxh64_intdigest(data, seed)
        assert native.xxh32(data, seed) == xxhash.xxh32_intdigest(data, seed)
    arr = rng.integers(0, 2**62, max(n // 8, 1), dtype=np.int64)
    assert native.xxh64(arr) == xxhash.xxh64_intdigest(arr.tobytes())
    assert native.xxh64(memoryview(data)) == xxhash.xxh64_intdigest(data)


def names(impl, k=60):
    mn = MODS[impl][2].MetricName
    out = []
    for i in range(k):
        d = {"__name__": ("up", "http_requests_total", "node_cpu")[i % 3],
             "instance": f"10.0.0.{i % 7}:9100", "id": str(i)}
        if i % 4:
            d["job"] = ("api", "db", "web")[i % 3]
        if i == 5:
            d["path"] = "/a\x00b\x01c"  # bytes the marshal escapes
        out.append(mn.from_dict(d))
    return out


def test_tsid_and_metric_name_match_reference():
    for a, b in zip(names("ref"), names("port")):
        assert a.marshal() == b.marshal()
        assert port_mn.MetricName.unmarshal(a.marshal()).marshal() == \
            a.marshal()
        for tenant in ((0, 0), (7, 3)):
            ta = ref_tsid.generate_tsid(a, 1234, tenant)
            tb = port_tsid.generate_tsid(b, 1234, tenant)
            assert ta.marshal() == tb.marshal()
            assert ta.sort_key() == tb.sort_key()
            assert port_tsid.TSID.unmarshal(ta.marshal()) == tb


def _tag_filter_specs():
    return [
        {"__name__": "up"},
        {"__name__": ("!=", "up")},
        {"__name__": ("=~", "http_.*|up")},
        {"job": ("!~", "a.*")},
        {"job": ""},
        {"instance": ("=~", "10\\.0\\.0\\.[1-3]:9100"), "job": "db"},
        {"path": ("=~", ".+")},
    ]


@pytest.mark.parametrize("spec", _tag_filter_specs())
def test_tag_filter_matches_reference(spec):
    fa, fb = ref_tf.filters_from_dict(spec), port_tf.filters_from_dict(spec)
    vals = [b"", b"up", b"api", b"db", b"http_requests_total",
            b"10.0.0.2:9100", b"10.0.0.9:9100", b"abc"]
    for a, b in zip(fa, fb):
        assert (a.key, a.value, a.negate, a.regex, a.or_values) == \
            (b.key, b.value, b.negate, b.regex, b.or_values)
        assert a.is_empty_match == b.is_empty_match
        assert [a.match_value(v) for v in vals] == \
            [b.match_value(v) for v in vals]


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_mergeset_matches_reference(tmp_path, writer):
    """Items added in batches to both tables (flushed, merged) search
    alike; the other implementation opens the writer's parts."""
    rng = np.random.default_rng(11)
    batches = [[bytes(rng.integers(0, 256, int(rng.integers(1, 40)),
                                   dtype=np.uint8)) + b"k%d" % i
                for i in range(j * 900, (j + 1) * 900)] for j in range(4)]
    batches.append([b"key%05d" % i for i in range(3000)])
    tables = {}
    for impl in ("ref", "port"):
        t = MODS[impl][0].Table(str(tmp_path / impl))
        for j, b in enumerate(batches):
            t.add_items(b)
            if j % 2:
                t.flush_to_disk()
        t.force_merge()
        t.add_items([b"key99999", b"key00001"])  # a pending tail
        tables[impl] = t

    def same(a, b):
        assert list(a.iter_from(b"")) == list(b.iter_from(b""))
        for p in (b"key0001", b"key", b"k", b"\x00", b"zz"):
            assert list(a.search_prefix(p)) == list(b.search_prefix(p))
            assert a.first_with_prefix(p) == b.first_with_prefix(p)
        for it in (b"key00001", b"key99999", b"nope", batches[0][5]):
            assert a.has_item(it) == b.has_item(it)
        assert a.item_count() == b.item_count()

    same(tables["ref"], tables["port"])
    for t in tables.values():
        t.close()
    other = "port" if writer == "ref" else "ref"
    shutil.copytree(tmp_path / writer, tmp_path / "copy")
    a = MODS[writer][0].Table(str(tmp_path / writer))
    b = MODS[other][0].Table(str(tmp_path / "copy"))
    try:
        same(a, b)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_index_db_matches_reference(tmp_path, writer):
    """The same names under the same TSIDs (fixed metric ids), global and
    per-day indexes and a delete, in both IndexDBs: every filter finds the
    same ids, tsids, names and labels; then each reads the other's
    directory."""
    date0 = 20_300
    day = 86_400_000
    dbs = {}
    for impl in ("ref", "port"):
        _, idb_mod, _, _, tsid_mod = MODS[impl]
        db = idb_mod.IndexDB(str(tmp_path / impl))
        for i, mn in enumerate(names(impl)):
            tsid = tsid_mod.generate_tsid(mn, 1000 + i, (0, 0))
            db.create_indexes_for_metric(mn, tsid)
            db.create_per_day_indexes(mn, tsid, date0 + i % 3)
        db.delete_series_by_ids(np.array([1003, 1010], dtype=np.uint64))
        dbs[impl] = db

    def tf(db, spec):
        mod = port_tf if isinstance(db, port_idb.IndexDB) else ref_tf
        return mod.filters_from_dict(spec)

    def same(a, b):
        lo, hi = date0 * day, (date0 + 3) * day - 1
        for spec in _tag_filter_specs():
            fa, fb = tf(a, spec), tf(b, spec)
            for rng_ in ((lo, hi), (lo, lo + day - 1), (None, None)):
                ia = a.search_metric_ids(fa, *rng_)
                ib = b.search_metric_ids(fb, *rng_)
                assert [int(x) for x in ia] == [int(x) for x in ib]
            ta = a.search_tsids(fa, lo, hi)
            tb = b.search_tsids(fb, lo, hi)
            assert [t.marshal() for t in ta] == [t.marshal() for t in tb]
        ids = list(range(1000, 1060))
        na, nb = a.get_metric_names_by_ids(ids), b.get_metric_names_by_ids(
            ids)
        assert {k: v[1] for k, v in na.items()} == \
            {k: v[1] for k, v in nb.items()}
        assert a.label_names() == b.label_names()
        for key in ("__name__", "job", "instance", "path"):
            assert a.label_values(key) == b.label_values(key)
        assert a.label_values("job", lo, lo + day - 1) == \
            b.label_values("job", lo, lo + day - 1)
        assert [int(x) for x in a.deleted_metric_ids] == \
            [int(x) for x in b.deleted_metric_ids] == [1003, 1010]
        raw = names("ref")[7].marshal()
        assert a.get_tsid_by_name(raw).marshal() == \
            b.get_tsid_by_name(raw).marshal()

    same(dbs["ref"], dbs["port"])
    for db in dbs.values():
        db.flush()
        db.close()
    other = "port" if writer == "ref" else "ref"
    shutil.copytree(tmp_path / writer, tmp_path / "copy")
    a = MODS[writer][1].IndexDB(str(tmp_path / writer))
    b = MODS[other][1].IndexDB(str(tmp_path / "copy"))
    try:
        same(a, b)
        assert os.listdir(tmp_path / "copy" / "months")
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("interval", [1_000, 15_000, 60_000])
def test_dedup_matches_reference(interval):
    rng = np.random.default_rng(interval)
    ts = np.sort(rng.integers(0, 600_000, 400)).astype(np.int64)
    ts[10:14] = ts[10]  # equal timestamps, one a stale marker
    v = np.round(rng.uniform(0, 10, 400), 2)
    v[11] = ref_dec.STALE_NAN
    a = ref_dedup.deduplicate(ts, v, interval)
    b = port_dedup.deduplicate(ts, v, interval)
    assert np.array_equal(a[0], b[0])
    assert np.array_equal(a[1].view(np.int64), b[1].view(np.int64))


def test_block_codec_matches_reference():
    """rows_to_blocks and the block marshal give the same bytes; each
    unmarshals the other's."""
    rng = np.random.default_rng(5)
    tsid_r = ref_tsid.generate_tsid(names("ref")[1], 77)
    tsid_p = port_tsid.generate_tsid(names("port")[1], 77)
    ts = np.sort(rng.integers(0, 10**9, 20_000)).astype(np.int64)
    for v in (np.cumsum(rng.integers(0, 9, 20_000)).astype(np.float64),
              np.round(rng.uniform(-5, 5, 20_000), 3)):
        ra = list(ref_block.rows_to_blocks(tsid_r, ts, v))
        pa = list(port_block.rows_to_blocks(tsid_p, ts, v))
        assert len(ra) == len(pa) == 3
        for a, b in zip(ra, pa):
            ha, *da = a.marshal()
            hb, *db = b.marshal()
            assert da == db and ha.marshal() == hb.marshal()
            back = port_block.Block.unmarshal(
                port_block.BlockHeader.unmarshal(ha.marshal()), *da)
            assert np.array_equal(back.timestamps, a.timestamps)
            assert np.array_equal(back.float_values().view(np.int64),
                                  a.float_values().view(np.int64))
