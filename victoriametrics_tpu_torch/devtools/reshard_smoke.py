"""Single-node -> 2-node reshard smoke (tools/lint.sh gate): the
elastic-cluster machinery must not rot between full tools/chaos.sh
runs.

One in-process pass over real loopback RPC (~5s):

1. a 1-node "cluster" ingests a small corpus;
2. a second vmstorage JOINS without a restart — new writes shard to
   it, ring-filtered reads stay bit-equal to the pre-join result;
3. rebalance_to moves finalized parts onto the joiner through the
   migrateParts_v1 family (crc-verified adoption, grace-deferred
   source delete) — reads stay byte-exact and vm_parts_migrated_total
   ticks;
4. with RF bumped via a fresh 2-node RF=2 router, a down node serves
   COMPLETE results through the explicit reroute path
   (vm_reroute_reads_total ticks).

Exit 0 on success, 1 on any violated invariant; a missing zstd codec
(no python binding AND no dlopen'd libzstd) skips loudly with exit 0 —
the smoke needs the RPC frame layer.  ``VMT_NO_RESHARD_SMOKE=1`` skips
from tools/lint.sh.

The port's copy of ``victoriametrics_tpu/devtools/reshard_smoke.py``,
whole.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile

import numpy as np

T0 = 1_753_700_000_000


def main() -> int:
    try:
        from ..ops import compress as _c
        _c.compress(b"probe")
    except Exception as e:  # pragma: no cover - env without any zstd
        print(f"reshard smoke: SKIP (no zstd codec: {e})")
        return 0
    os.environ.setdefault("VM_MIGRATE_GRACE_MS", "50")
    from ..parallel.cluster_api import (ClusterStorage, StorageNodeClient,
                                        make_storage_handlers,
                                        parse_node_spec)
    from ..parallel.rpc import HELLO_INSERT, HELLO_SELECT, RPCServer
    from ..storage.storage import Storage
    from ..storage.tag_filters import TagFilter
    from ..utils import metrics as metricslib

    migrated = metricslib.REGISTRY.counter("vm_parts_migrated_total")
    reroutes = metricslib.REGISTRY.counter("vm_reroute_reads_total")
    tmp = tempfile.mkdtemp(prefix="reshard-smoke-")
    stores, servers = [], []

    def spawn():
        s = Storage(tempfile.mkdtemp(dir=tmp))
        h = make_storage_handlers(s)
        ins = RPCServer("127.0.0.1", 0, HELLO_INSERT, h)
        sel = RPCServer("127.0.0.1", 0, HELLO_SELECT, h)
        ins.start()
        sel.start()
        stores.append(s)
        servers.extend((ins, sel))
        return s, f"127.0.0.1:{ins.port}:{sel.port}"

    def fetch(cluster):
        return cluster.search_columns([TagFilter(b"", b"rs")], T0,
                                      T0 + 10 * 15_000)

    try:
        s1, spec1 = spawn()
        cluster = ClusterStorage([StorageNodeClient(
            *parse_node_spec(spec1))])
        for b in range(3):  # several flushes -> several movable parts
            cluster.add_rows(
                [({"__name__": "rs", "series": str(i)},
                  T0 + (3 * b + j) * 15_000, float(i * 10 + b + j))
                 for i in range(50) for j in range(3)])
            s1.force_flush()
        want = fetch(cluster)
        assert want.n_series == 50, want.n_series

        # JOIN without restart; ring-filtered reads stay bit-equal
        s2, spec2 = spawn()
        cluster.add_node(spec2)
        got = fetch(cluster)
        assert got.raw_names == want.raw_names
        assert np.array_equal(got.vals, want.vals)
        cluster.add_rows([({"__name__": "rs2", "series": str(i)}, T0,
                           float(i)) for i in range(40)])
        assert s2.rows_added > 0, "joiner took no writes"

        # rebalance moves real parts; reads stay byte-exact
        m0 = migrated.get()
        stat = cluster.rebalance_to(cluster.node_names()[1])
        assert stat["parts"] >= 1, f"rebalance moved nothing: {stat}"
        assert migrated.get() > m0
        assert s2.list_file_parts(), "no adopted parts on the joiner"
        got = fetch(cluster)
        assert got.raw_names == want.raw_names
        assert np.array_equal(got.vals, want.vals)

        # RF=2 reroute: a down node still serves COMPLETE results
        rf2 = ClusterStorage(
            [StorageNodeClient(*parse_node_spec(sp))
             for sp in (spec1, spec2)], replication_factor=2)
        rf2.add_rows([({"__name__": "rr", "series": str(i)},
                       T0 + j * 15_000, float(i + j))
                      for i in range(30) for j in range(3)])
        f = [TagFilter(b"", b"rr")]
        before = rf2.search_columns(f, T0, T0 + 60_000)
        r0 = reroutes.get()
        rf2.nodes[0].mark_down(30.0)
        rf2.reset_partial()
        after = rf2.search_columns(f, T0, T0 + 60_000)
        assert after.raw_names == before.raw_names
        assert np.array_equal(after.vals, before.vals)
        assert not rf2.last_partial, "reroute read flagged partial"
        assert reroutes.get() > r0, "vm_reroute_reads_total never ticked"
        print(f"reshard smoke: OK (rebalanced {stat['parts']} parts / "
              f"{stat['bytes']} bytes; reroute served "
              f"{after.n_series} series complete)")
        return 0
    except AssertionError as e:
        print(f"reshard smoke: FAIL: {e}")
        return 1
    finally:
        for srv in servers:
            srv.stop()
        for s in stores:
            s.close()
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
