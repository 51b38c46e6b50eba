"""Rendezvous (highest-random-weight) hashing for series->storage-node
placement with exclusion lists for rerouting around unhealthy nodes
(reference lib/consistenthash/consistent_hash.go:11-55).

The port's copy of ``victoriametrics_tpu/parallel/consistenthash.py``,
hashing with the native codec's ``native.xxh64`` (equal to the
``xxhash`` package's ``xxh64_intdigest``), so both packages place every
series on the same nodes."""

from __future__ import annotations

from .. import native


class ConsistentHash:
    def __init__(self, node_ids: list[str], seed: int = 0):
        self.node_ids = list(node_ids)
        self._node_hashes = [
            native.xxh64(n.encode(), seed) for n in node_ids]

    def node_index(self, key_hash: int, excluded: set[int] | None = None) -> int:
        """Pick the node for a key (already hashed), skipping excluded
        indexes. Returns -1 if all nodes are excluded."""
        best = -1
        best_w = -1
        kb = key_hash.to_bytes(8, "little")
        for i, nh in enumerate(self._node_hashes):
            if excluded and i in excluded:
                continue
            # mix the key hash with the node hash (rendezvous weight)
            w = native.xxh64(kb, nh & 0xFFFFFFFF)
            if w > best_w:
                best_w = w
                best = i
        return best

    def nodes_for_key(self, key: bytes, replication: int = 1,
                      excluded: set[int] | None = None) -> list[int]:
        """Top-N distinct nodes for a key (write fan-out under
        -replicationFactor=N)."""
        kh = native.xxh64(key)
        out: list[int] = []
        ex = set(excluded or ())
        while len(out) < replication:
            i = self.node_index(kh, ex)
            if i < 0:
                break
            out.append(i)
            ex.add(i)
        return out
