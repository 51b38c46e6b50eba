"""Cluster RPC, as far as the HTTP layer needs it: the typed errors its
handlers map to HTTP statuses and the ``Writer``/``Reader`` field framing
of ``/api/v1/export/native`` and ``/api/v1/import/native``.

The port's copy of part of ``victoriametrics_tpu/parallel/rpc.py``
(``:101-130`` and ``:196-270``).  The RPC server, client, pool and frame
transport, and the cluster fan-out that raises these errors
(``cluster_api.py``), wait for the cluster slice (ROADMAP.md section A,
item 11); a single-node server never raises them, but its handlers keep
the reference's mapping.
"""

from __future__ import annotations

import struct

import numpy as np

from ..ops.varint import marshal_varuint64, unmarshal_varuint64


class RPCError(RuntimeError):
    pass


class RPCDeadlineError(RPCError):
    """The caller's deadline expired before the call completed.  A
    subclass of RPCError so transport layers treat it as a terminal
    call failure (never retried — there is no budget left to retry
    in).  ``waited`` is False when the budget was already exhausted
    BEFORE any I/O touched the peer: the node never misbehaved, so
    health tracking must not mark it down for one over-budget query."""

    waited = True


class ClusterUnavailableError(RPCError):
    """Every storage node failed the fan-out: there is no data to serve
    at all.  HTTP layers map this to 503 (+ the first node's error)
    rather than a generic 500 — the cluster is degraded, the serving
    code is not broken."""


class PartialResultError(RuntimeError):
    """deny_partial is set and a fan-out lost node(s): the merged
    answer would be silently incomplete, so the query is refused.
    Capacity degradation, not a serving bug — boundaries map it to 503,
    never an anonymous 500."""


# -- marshaling helpers ------------------------------------------------------

class Writer:
    def __init__(self):
        self.buf = bytearray()

    def bytes_(self, b: bytes):
        self.buf += marshal_varuint64(len(b))
        self.buf += b
        return self

    def str_(self, s: str):
        return self.bytes_(s.encode())

    def u64(self, x: int):
        self.buf += marshal_varuint64(x)
        return self

    def i64(self, x: int):
        self.buf += struct.pack(">q", x)
        return self

    def f64(self, x: float):
        self.buf += struct.pack(">d", x)
        return self

    def array(self, a: np.ndarray):
        raw = np.ascontiguousarray(a).tobytes()
        self.bytes_(str(a.dtype).encode())
        return self.bytes_(raw)

    def payload(self) -> bytes:
        return bytes(self.buf)


class Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.i = 0

    def bytes_(self) -> bytes:
        n, self.i = unmarshal_varuint64(self.data, self.i)
        out = self.data[self.i:self.i + n]
        if len(out) != n:
            raise RPCError("rpc: truncated bytes field")
        self.i += n
        return out

    def str_(self) -> str:
        return self.bytes_().decode()

    def u64(self) -> int:
        v, self.i = unmarshal_varuint64(self.data, self.i)
        return v

    def i64(self) -> int:
        v = struct.unpack_from(">q", self.data, self.i)[0]
        self.i += 8
        return v

    def f64(self) -> float:
        v = struct.unpack_from(">d", self.data, self.i)[0]
        self.i += 8
        return v

    def array(self) -> np.ndarray:
        dtype = self.bytes_().decode()
        raw = self.bytes_()
        return np.frombuffer(raw, dtype=dtype).copy()

    @property
    def remaining(self) -> int:
        return len(self.data) - self.i
