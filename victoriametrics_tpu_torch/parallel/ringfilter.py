"""Reroute-aware read serving: per-series ring-ownership filtering on the
storage node.

The vmselect ships its consistent-hash view — node names, replication
factor, the target node's own index, and the currently-down node
indexes — as a trailing ``search_v1``/``searchColumns_v1`` field.  A
storage node that understands it serves only the series it OWNS under
that ring instead of everything it has:

- healthy ring: node i serves exactly the series whose rendezvous
  first choice is i.  With RF=N a full fan-out otherwise returns N
  copies of every series (the vmselect dedups them after shipping),
  so ownership filtering divides wire bytes and vmselect merge work
  by RF.  The filter currently runs AFTER the node's own fetch (the
  handlers apply keep_mask to the search result), so node-side disk
  scan/decode still reads every replica copy — pushing the mask into
  the index-resolution stage is a named follow-up;
- down node d: the first choice is re-computed EXCLUDING d
  (``ConsistentHash.nodes_for_key`` exclusion sets), so each survivor
  explicitly serves the slice of d's hash ranges for which it is the
  RF-2 replica — a one-node outage costs only that node's key share,
  never a partial result or a full re-fan (``vm_reroute_reads_total``
  ticks on both sides);
- orphan data — series a node holds although the ring says it is not
  among their RF owners (write reroutes while an owner was down, parts
  adopted by live resharding, a ring that shrank) — is ALWAYS served:
  the rightful owner may not have those bytes, and duplicate rows
  collapse in the vmselect's raw-name merge exactly like replica
  overlap.

The filter is an ownership claim, so it is only honored by backends
that actually hold ring-placed data: ``storage.Storage`` declares
``supports_ring_filter``; a multilevel vmselect's ClusterStorage does
NOT (its own nodes were not placed by the caller's ring), so the
mid-level returns unfiltered rows, acks nothing, and the top-level
dedup keeps correctness.  Peers that never ack (old nodes) degrade the
optimization, never the result.

Known trade (documented in README): a node that was down and lost
writes to its RF-2 replica serves its primary share again the moment
it is back, so rows written during its downtime are hidden until the
replica copy lands back on it (a merge/migration concern, not a test
concern — the down-marking window is ~2s).  ``VM_RING_FILTER=0``
restores the full-coverage fan-out and is the bit-equality oracle.

The port's copy of ``victoriametrics_tpu/parallel/ringfilter.py``; its
locks come from the port's ``devtools/locktrace.make_lock`` (plain
``threading.Lock``).
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np

from ..devtools.locktrace import make_lock
from ..utils import metrics as metricslib
from .consistenthash import ConsistentHash

#: reads served from a replica for a DOWN node's hash ranges (ticks on
#: the vmselect per rerouted fan-out and on each storage node per
#: rerouted search it answered)
REROUTE_READS = metricslib.REGISTRY.counter("vm_reroute_reads_total")

_TEN = struct.Struct(">II")


def enabled() -> bool:
    """Ring-ownership read filtering (default on); ``VM_RING_FILTER=0``
    is the escape hatch and full-fan-out bit-equality oracle."""
    return os.environ.get("VM_RING_FILTER", "1") != "0"


class RingConfig:
    """One (node list, rf, self index, down set) view, with a bounded
    per-series ownership memo — a rolling dashboard re-reads the same
    series every refresh, so the two rendezvous hashes per series run
    once per ring state, not once per query."""

    _MAX_MEMO = 1 << 20

    def __init__(self, nodes: list[str], rf: int, self_index: int,
                 down: frozenset[int]):
        self.nodes = list(nodes)
        self.rf = max(int(rf), 1)
        self.self_index = int(self_index)
        self.down = frozenset(int(d) for d in down)
        self.ch = ConsistentHash(self.nodes)
        self._memo: dict[bytes, tuple[bool, bool]] = {}
        self._lock = make_lock("parallel.RingConfig._memo")

    def to_json(self) -> bytes:
        return json.dumps({"nodes": self.nodes, "rf": self.rf,
                           "self": self.self_index,
                           "down": sorted(self.down)}).encode()

    @classmethod
    def from_json(cls, data: bytes) -> "RingConfig | None":
        try:
            d = json.loads(data)
            return cls(list(d["nodes"]), int(d.get("rf", 1)),
                       int(d["self"]), frozenset(d.get("down", ())))
        except (ValueError, KeyError, TypeError):
            return None  # malformed ring never fails the search

    def _verdict(self, key: bytes) -> tuple[bool, bool]:
        """(serve, rerouted) for one placement key (tenant prefix +
        canonical metric-name marshal — the write router's shard key)."""
        owners = self.ch.nodes_for_key(key, self.rf)
        if self.self_index not in owners:
            # orphan data: the ring says this node should not hold the
            # series, so nobody else is guaranteed to — always serve
            return True, False
        first = self.ch.nodes_for_key(key, 1, set(self.down))
        serve = bool(first) and first[0] == self.self_index
        # rerouted: this node serves a share whose unexcluded primary
        # is currently down (the explicit replica read)
        rerouted = serve and bool(self.down) and owners[0] in self.down
        return serve, rerouted

    def keep_mask(self, tenant, raw_names,
                  exempt=None) -> tuple[np.ndarray, int]:
        """Boolean keep mask over ``raw_names`` (canonical marshals) +
        how many kept series were served via reroute.  ``exempt`` is
        the node's always-serve set (``Storage.ring_exempt_names``:
        series adopted by part migration or landed by write reroutes —
        this node may hold their only copy, so ownership suppression
        never applies)."""
        tkey = _TEN.pack(tenant[0], tenant[1])
        keep = np.empty(len(raw_names), bool)
        rerouted = 0
        memo = self._memo
        for i, raw in enumerate(raw_names):
            if exempt is not None and raw in exempt:
                keep[i] = True
                continue
            key = tkey + raw
            got = memo.get(key)
            if got is None:
                got = self._verdict(key)
                with self._lock:
                    if len(memo) >= self._MAX_MEMO:
                        memo.clear()
                    memo[key] = got
            keep[i] = got[0]
            rerouted += got[1]
        return keep, rerouted


# ring states are few (node lists x small down sets); intern them so the
# per-series memo survives across calls
_RINGS: dict[tuple, RingConfig] = {}
_RINGS_LOCK = make_lock("parallel.ringfilter._RINGS")
_MAX_RINGS = 64


def get_ring(nodes, rf: int, self_index: int, down) -> RingConfig:
    """Interned RingConfig for one (nodes, rf, self, down) state — both
    sides use this so the per-series memos survive across calls."""
    sig = (tuple(nodes), int(rf), int(self_index), frozenset(down))
    with _RINGS_LOCK:
        got = _RINGS.get(sig)
        if got is not None:
            return got
    rc = RingConfig(list(nodes), rf, self_index, frozenset(down))
    with _RINGS_LOCK:
        if len(_RINGS) >= _MAX_RINGS:
            _RINGS.clear()
        return _RINGS.setdefault(sig, rc)


def intern_ring(data: bytes) -> RingConfig | None:
    """Parse + intern a shipped ring config (None on malformed)."""
    rc = RingConfig.from_json(data)
    if rc is None:
        return None
    return get_ring(rc.nodes, rc.rf, rc.self_index, rc.down)
