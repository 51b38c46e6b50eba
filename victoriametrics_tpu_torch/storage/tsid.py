"""TSID: the sortable numeric series identity (reference lib/storage/tsid.go:17,
generated at index_db.go:412).

The port's copy of ``victoriametrics_tpu/storage/tsid.py``; the clustering
hashes come from the native codec's xxh64/xxh32 (``native.xxh64``/
``native.xxh32``, equal to the ``xxhash`` package's intdigests).

Sort order clusters blocks of related series together on disk:
(metric_group_id, job_id, instance_id, metric_id). metric_id alone is
globally unique and is the key used by posting lists and caches.
"""

from __future__ import annotations

import struct
import time

from .. import native
from ..devtools.locktrace import make_lock

_FMT = struct.Struct(">IIQIIQ")  # account, project, group, job, instance, metric


class TSID:
    """Sort order starts with (account_id, project_id) so one tenant's
    blocks cluster together on disk (reference tsid.go:17 Less())."""

    __slots__ = ("account_id", "project_id", "metric_group_id", "job_id",
                 "instance_id", "metric_id")

    SIZE = _FMT.size

    def __init__(self, metric_group_id=0, job_id=0, instance_id=0,
                 metric_id=0, account_id=0, project_id=0):
        self.account_id = account_id
        self.project_id = project_id
        self.metric_group_id = metric_group_id
        self.job_id = job_id
        self.instance_id = instance_id
        self.metric_id = metric_id

    def marshal(self) -> bytes:
        return _FMT.pack(self.account_id, self.project_id,
                         self.metric_group_id, self.job_id, self.instance_id,
                         self.metric_id)

    @classmethod
    def unmarshal(cls, data: bytes, offset: int = 0) -> "TSID":
        a, p, g, j, i, m = _FMT.unpack_from(data, offset)
        return cls(g, j, i, m, a, p)

    def sort_key(self) -> tuple:
        return (self.account_id, self.project_id, self.metric_group_id,
                self.job_id, self.instance_id, self.metric_id)

    def __lt__(self, other):
        return self.sort_key() < other.sort_key()

    def __eq__(self, other):
        return self.sort_key() == other.sort_key()

    def __hash__(self):
        return hash(self.metric_id)

    def __repr__(self):
        return (f"TSID(g={self.metric_group_id:x}, j={self.job_id:x}, "
                f"i={self.instance_id:x}, m={self.metric_id:x})")


class MetricIDGenerator:
    """Unique metric_id source: coarse-time-seeded counter (reference
    generateUniqueMetricID uses an atomic counter seeded from nanotime so ids
    stay unique across restarts without persistence)."""

    def __init__(self):
        self._lock = make_lock("storage.MetricIDGenerator._lock")
        from ..utils import fasttime
        self._next = fasttime.unix_ns() & ((1 << 62) - 1)

    def next_id(self) -> int:
        with self._lock:
            self._next += 1
            return self._next

    def reserve_past(self, metric_id: int) -> None:
        """Advance the counter past a FOREIGN metric_id (series adopted
        from another node via part migration): ids this node generates
        later must never collide with ids it adopted."""
        with self._lock:
            if metric_id > self._next:
                self._next = metric_id


def generate_tsid(mn, metric_id: int, tenant=(0, 0)) -> TSID:
    """Derive the clustering hash fields from the metric name."""
    t = TSID(metric_id=metric_id, account_id=tenant[0], project_id=tenant[1])
    t.metric_group_id = native.xxh64(mn.metric_group)
    job = mn.get_label(b"job")
    if job:
        t.job_id = native.xxh32(job)
    inst = mn.get_label(b"instance")
    if inst:
        t.instance_id = native.xxh32(inst)
    return t
