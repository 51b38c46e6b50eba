"""Cluster RPC: length-prefixed binary frames over TCP with a versioned
handshake and negotiated zstd compression (reference lib/handshake/
handshake.go:17-160 + lib/vmselectapi/server.go framing).

Frame: u32 BE length + payload. Payload (optionally zstd): method name
(varuint len + bytes) + method-specific body. Responses: status byte
(0=ok, 1=error+message) + body. Calls are versioned through their method
names ("writeRows_v1", "search_v1", ...) for rolling-upgrade compat.

The port's copy of ``victoriametrics_tpu/parallel/rpc.py``, whole: the
hello bytes, the frames and the error markers are the reference's, so a
cluster may mix the two packages' nodes.  Frames go through the port's
``ops/compress``: zstd from the ``zstandard`` package, else the native
library's libzstd, else zlib; ``decompress`` sniffs the frame magic, so
either side reads the other's frames whichever codec wrote them
(``frame_codec`` names the one this host writes).
"""

from __future__ import annotations

import io
import os
import random
import socket
import socketserver
import struct
import threading
import time

import numpy as np

from ..devtools import faultinject
from ..devtools.locktrace import make_lock
from ..devtools.racetrace import traced_fields
from ..ingest.ratelimiter import RateLimitedError

try:
    from ..ops import compress as zstd
except ImportError:  # optional native dep (zstandard): the marshal layer
    zstd = None      # (Writer/Reader) stays importable; only frame I/O needs it

from ..ops.varint import marshal_varuint64, unmarshal_varuint64
from ..utils import logger
from ..utils import metrics as metricslib
from ..utils.deadline import DeadlineExceededError
from ..utils.workpool import SearchLimitError

#: wire marker for shed-load errors (TenantGate rejections): the client
#: re-raises them as SearchLimitError so a tenant-quota 429 crosses the
#: RPC boundary as ITSELF — not as a generic node failure that would
#: mark the (healthy) storage node down and go partial for every tenant
_SHED_PREFIX = "vm:shed-load: "

#: wire marker for storage-side deadline aborts: the vmstorage stopped
#: a scan/fetch because the SHIPPED budget expired — by-design behavior
#: requested by the caller, so the client re-raises a deadline error
#: with waited=False and the fan-out never marks the healthy node down
_DEADLINE_PREFIX = "vm:deadline: "

#: wire marker for ingestion rate-limit rejections: carries ONLY the
#: retry-after seconds so the client can rebuild the typed
#: RateLimitedError and the vminsert HTTP layer keeps its 429 +
#: Retry-After contract across the RPC hop
_RATELIMIT_PREFIX = "vm:rate-limited: "

#: wire marker for a multilevel child whose OWN fan-out found no live
#: storage at all: the parent re-raises ClusterUnavailableError so its
#: HTTP layer serves the promised 503, not an anonymous 500
_UNAVAIL_PREFIX = "vm:unavailable: "

#: wire marker for deny_partial rejections on a multilevel child: the
#: parent re-raises PartialResultError (capacity degradation, 503)
_PARTIAL_PREFIX = "vm:partial-denied: "


# per-(family, method) handle memo: keeps the format_name + name-regex +
# registry-lock round trip off the per-call path (method sets are tiny and
# bounded; a benign double-create under race resolves to the same handle)
_metric_memo: dict[tuple, object] = {}


def _rpc_counter(name: str, method: str):
    key = (name, method)
    m = _metric_memo.get(key)
    if m is None:
        # benign double-create: REGISTRY.counter dedups by name, so two
        # racing fills store the same object
        m = _metric_memo[key] = metricslib.REGISTRY.counter(  # vmt: disable=VMT015
            metricslib.format_name(name, {"method": method}))
    return m


def _rpc_histogram(name: str, method: str):
    key = (name, method)
    m = _metric_memo.get(key)
    if m is None:
        m = _metric_memo[key] = metricslib.REGISTRY.histogram(
            metricslib.format_name(name, {"method": method}))
    return m

HELLO_INSERT = b"vmtpu-insert.v2\n"
HELLO_SELECT = b"vmtpu-select.v2\n"
HELLO_OK = b"ok:zstd\n"

_U32 = struct.Struct(">I")
MAX_FRAME = 256 << 20


class RPCError(RuntimeError):
    pass


class RPCDeadlineError(RPCError):
    """The caller's deadline expired before the call completed.  A
    subclass of RPCError so transport layers treat it as a terminal
    call failure (never retried — there is no budget left to retry
    in).  ``waited`` is False when the budget was already exhausted
    BEFORE any I/O touched the peer: the node never misbehaved, so
    health tracking (ClusterStorage._fanout) must not mark it down for
    one over-budget query."""

    waited = True


class ClusterUnavailableError(RPCError):
    """Every storage node failed the fan-out: there is no data to serve
    at all.  HTTP layers map this to 503 (+ the first node's error)
    rather than a generic 500 — the cluster is degraded, the serving
    code is not broken.  Defined here (not cluster_api) so both error
    boundaries can map it without importing the fan-out machinery, and
    so a multilevel child's unavailability crosses the RPC hop typed
    (``_UNAVAIL_PREFIX``)."""


class PartialResultError(RuntimeError):
    """deny_partial is set and a fan-out lost node(s): the merged
    answer would be silently incomplete, so the query is refused.
    Capacity degradation, not a serving bug — boundaries map it to 503
    / a typed ``_PARTIAL_PREFIX`` frame, never an anonymous 500."""


# cross-method aggregates: the per-method vm_rpc_client_* families stay,
# these are the "is the cluster retrying/timing out AT ALL" alarms
_RETRIES_TOTAL = metricslib.REGISTRY.counter("vm_rpc_retries_total")
_DEADLINE_EXCEEDED_TOTAL = metricslib.REGISTRY.counter(
    "vm_rpc_deadline_exceeded_total")


def _retry_policy() -> tuple[int, float, float]:
    """(max reconnect retries, backoff base s, backoff cap s) —
    re-read per call so tests and operators tune live.
    ``VM_RPC_RETRIES`` (default 2), ``VM_RPC_BACKOFF_MS`` (default 20),
    ``VM_RPC_BACKOFF_MAX_MS`` (default 2000)."""
    def _num(name: str, default: float) -> float:
        try:
            return float(os.environ.get(name, "") or default)
        except ValueError:
            return default
    return (max(int(_num("VM_RPC_RETRIES", 2)), 0),
            max(_num("VM_RPC_BACKOFF_MS", 20.0), 0.0) / 1e3,
            max(_num("VM_RPC_BACKOFF_MAX_MS", 2000.0), 1.0) / 1e3)


def _acquire_cap_s() -> float:
    """Upper bound on waiting for a pooled connection when the call
    carries NO deadline (insert-path calls): a pool whose connections
    are all wedged behind a dead peer must surface as an error instead
    of hanging the caller forever.  ``VM_RPC_ACQUIRE_MAX_S`` (default
    60) — generous enough that real backpressure never trips it."""
    try:
        return float(os.environ.get("VM_RPC_ACQUIRE_MAX_S", "") or 60.0)
    except ValueError:
        return 60.0


def _read_exact(sock_file, n: int) -> bytes:
    data = sock_file.read(n)
    if data is None or len(data) != n:
        raise ConnectionError("rpc: connection closed mid-frame")
    return data


def write_frame(sock_file, payload: bytes, compress: bool = True):
    if zstd is None:
        raise RPCError("rpc frames need the 'zstandard' package")
    if compress:
        payload = zstd.compress(payload)
    sock_file.write(_U32.pack(len(payload)) + payload)
    sock_file.flush()


def read_frame(sock_file, compressed: bool = True) -> bytes:
    if zstd is None:
        raise RPCError("rpc frames need the 'zstandard' package")
    n = _U32.unpack(_read_exact(sock_file, 4))[0]
    if n > MAX_FRAME:
        raise RPCError(f"rpc frame too large: {n}")
    data = _read_exact(sock_file, n)
    return zstd.decompress(data) if compressed else data



def frame_codec() -> str:
    """The codec ``write_frame`` compresses with on this host: "zstd"
    (the ``zstandard`` package), "zstd-native" (the native library's
    libzstd) or "zlib" (neither present)."""
    if zstd is None:
        return "none"
    if zstd.zstandard is not None:
        return "zstd"
    return "zstd-native" if zstd.zstd_available() else "zlib"

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


# -- server ------------------------------------------------------------------

class RPCServer:
    """TCP server dispatching named methods. Handlers: fn(Reader) -> Writer
    or an iterator of Writers for streaming responses (each streamed frame is
    prefixed with status 2; final frame status 0)."""

    def __init__(self, addr: str, port: int, hello: bytes,
                 handlers: dict[str, object], max_conns: int = 64):
        self.handlers = handlers
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                try:
                    got = _read_exact(self.rfile, len(hello))
                    if got != hello:
                        self.wfile.write(b"bad hello\n")
                        return
                    self.wfile.write(HELLO_OK)
                    self.wfile.flush()
                    while True:
                        try:
                            req = read_frame(self.rfile)
                        except (ConnectionError, RPCError):
                            return
                        try:
                            outer._dispatch(req, self.wfile)
                        except faultinject.ConnectionAbort:
                            # injected reset: drop the peer mid-frame,
                            # exercising the client's reconnect path
                            return
                except (BrokenPipeError, ConnectionResetError):
                    return

        class Srv(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._srv = Srv((addr, port), Handler)
        self.port = self._srv.server_address[1]
        # long-lived RPC accept loop, one per server — not fan-out work
        self._thread = threading.Thread(  # vmt: disable=VMT011
            target=self._srv.serve_forever, daemon=True)

    def start(self):
        self._thread.start()

    def stop(self):
        self._srv.shutdown()
        self._srv.server_close()

    def _dispatch(self, req: bytes, wfile):
        r = Reader(req)
        method = "?"
        t0 = time.perf_counter()
        try:
            method = r.str_()
            _rpc_counter("vm_rpc_server_calls_total", method).inc()
            # chaos seam: injected delays/stalls/errors/resets land here,
            # between frame parse and handler dispatch (devtools/faultinject)
            if faultinject.active():
                faultinject.fire("rpc:" + method)
            fn = self.handlers.get(method)
            if fn is None:
                raise RPCError(f"unknown rpc method {method!r}")
            out = fn(r)
            if hasattr(out, "__iter__") and not isinstance(out, Writer):
                for w in out:
                    write_frame(wfile, b"\x02" + w.payload())
                write_frame(wfile, b"\x00")
            else:
                body = out.payload() if isinstance(out, Writer) else b""
                write_frame(wfile, b"\x00" + body)
        except faultinject.ConnectionAbort:
            raise  # handled at the connection loop (drop, no response)
        except DeadlineExceededError as e:
            # the handler aborted because the query's SHIPPED budget
            # expired — by-design (vm_storage_deadline_aborts_total on
            # this node already counted it), not a handler error: no
            # error-log line, no vm_rpc_server_errors_total, and the
            # typed wire marker keeps it a deadline on the caller's side
            _rpc_counter("vm_rpc_server_deadline_total", method).inc()
            try:
                write_frame(wfile,
                            b"\x01" + (_DEADLINE_PREFIX + str(e)).encode())
            except OSError:
                pass
        except SearchLimitError as e:
            # by-design shed load, NOT a handler error: it has its own
            # accounting (vm_rpc_server_shed_total here, the gate's
            # vm_tenant_search_rejected_total on the storage side) and
            # must not flood the error log / error counter during a 429
            # storm.  The wire marker keeps the type across the hop.
            _rpc_counter("vm_rpc_server_shed_total", method).inc()
            try:
                write_frame(wfile,
                            b"\x01" + (_SHED_PREFIX + str(e)).encode())
            except OSError:
                pass
        except RateLimitedError as e:
            # ingestion backpressure, the write-plane twin of shed load:
            # only the retry-after seconds cross the wire, the client
            # rebuilds the typed error so vminsert's 429 + Retry-After
            # contract survives the hop instead of becoming a 500
            _rpc_counter("vm_rpc_server_ratelimited_total", method).inc()
            try:
                write_frame(wfile, b"\x01" + (
                    _RATELIMIT_PREFIX + str(e.retry_after_s)).encode())
            except OSError:
                pass
        except ClusterUnavailableError as e:
            # a multilevel child found no live storage: typed marker so
            # the parent's HTTP layer serves the promised 503 (before
            # the RPCError arm — it is a subclass)
            _rpc_counter("vm_rpc_server_errors_total", method).inc()
            try:
                write_frame(wfile,
                            b"\x01" + (_UNAVAIL_PREFIX + str(e)).encode())
            except OSError:
                pass
        except PartialResultError as e:
            # deny_partial refusal on a multilevel child: capacity
            # degradation the parent must surface as 503, not 500
            _rpc_counter("vm_rpc_server_errors_total", method).inc()
            try:
                write_frame(wfile,
                            b"\x01" + (_PARTIAL_PREFIX + str(e)).encode())
            except OSError:
                pass
        except RPCError as e:
            # the unmarked error frame IS the typed encoding of
            # RPCError: the client re-raises it as RPCError verbatim,
            # so the type round-trips the hop.  A separate arm (same
            # body as the anonymous one) keeps that contract explicit
            # for the VMT016 exception-escape audit.
            _rpc_counter("vm_rpc_server_errors_total", method).inc()
            logger.errorf("rpc handler error: %s", e)
            try:
                write_frame(wfile, b"\x01" + str(e).encode())
            except OSError:
                pass
        except Exception as e:  # noqa: BLE001 — rpc error boundary
            _rpc_counter("vm_rpc_server_errors_total", method).inc()
            logger.errorf("rpc handler error: %s", e)
            try:
                write_frame(wfile, b"\x01" + str(e).encode())
            except OSError:
                pass
        finally:
            _rpc_histogram("vm_rpc_server_call_duration_seconds",
                           method).update(time.perf_counter() - t0)


# -- client ------------------------------------------------------------------

@traced_fields("_sock", "_f")
class RPCClient:
    """One connection per client; callers serialize via a lock (the pool
    layer holds several clients per node)."""

    def __init__(self, host: str, port: int, hello: bytes, timeout=10.0):
        self.addr = (host, port)
        self.hello = hello
        self.timeout = timeout
        self._lock = make_lock("rpc.RPCClient._lock")
        self._sock = None
        self._f = None

    def _op_timeout(self, deadline: float) -> float:
        """Per-operation socket timeout: the configured ceiling, clipped
        to the caller's remaining budget (a query with 800ms left must
        not sit in a 10s default timeout against a hung peer)."""
        if not deadline:
            return self.timeout
        return max(min(self.timeout, deadline - time.monotonic()), 0.001)

    def _check_deadline(self, method: str, deadline: float,
                        waited: bool = True) -> None:
        if deadline and time.monotonic() >= deadline:
            _DEADLINE_EXCEEDED_TOTAL.inc()
            _rpc_counter("vm_rpc_client_deadline_exceeded_total",
                         method).inc()
            err = RPCDeadlineError(
                f"rpc {method} to {self.addr[0]}:{self.addr[1]}: "
                f"caller deadline exceeded")
            err.waited = waited
            raise err

    def _connect(self, deadline: float = 0.0):
        # connection establishment honors the caller's deadline too —
        # the constructor timeout is only the no-deadline ceiling
        sock = socket.create_connection(self.addr,
                                        timeout=self._op_timeout(deadline))
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        f = sock.makefile("rwb")
        f.write(self.hello)
        f.flush()
        resp = f.read(len(HELLO_OK))
        if resp != HELLO_OK:
            raise RPCError(f"handshake failed: {resp!r}")
        self._sock, self._f = sock, f

    def close(self):
        with self._lock:
            self._close_locked()

    def _close_locked(self):
        """Close without taking the lock — for use on paths already holding
        self._lock (calling close() there self-deadlocks on the plain Lock)."""
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = self._f = None

    def call(self, method: str, w: Writer | None = None,
             deadline: float = 0.0) -> Reader:
        """Unary call."""
        frames = list(self.call_stream(method, w, deadline=deadline))
        if frames:
            return frames[0]
        return Reader(b"")

    def call_stream(self, method: str, w: Writer | None = None,
                    deadline: float = 0.0):
        """Returns an iterator of Readers, one per streamed frame.

        `deadline` is a ``time.monotonic()`` cutoff (0 = none): every
        socket operation — connect included — runs under a timeout
        derived from the REMAINING budget (capped by the constructor
        timeout), so a hung peer costs the caller at most its own
        deadline, never a fixed 10s-per-hop default.  An exhausted
        budget raises :class:`RPCDeadlineError` and counts into
        ``vm_rpc_deadline_exceeded_total``.

        Connection-level failures (peer restarted, stale kept-alive
        connection, injected resets) are retried on a fresh connection
        with bounded exponential backoff + full jitter (see
        :func:`_retry_policy`), as long as no response frame has been
        received and budget remains; each retry counts into
        ``vm_rpc_retries_total``.  A socket TIMEOUT is not retried —
        the peer is slow, not gone, and retrying would burn the rest of
        the budget re-waiting on the same stall.

        All frames are read under the lock BEFORE returning: a lazy
        generator would keep the connection lock held while the caller
        processes frames, and an abandoned generator (consumer error) would
        leave it locked until GC — a deadlock under failure. Any transport
        error also tears the connection down so a half-read stream can never
        poison the next call."""
        req = Writer().str_(method)
        if w is not None:
            req.buf += w.buf
        frames: list[Reader] = []
        _rpc_counter("vm_rpc_client_calls_total", method).inc()
        t0 = time.perf_counter()
        max_retries, backoff_base, backoff_cap = _retry_policy()
        try:
            with self._lock:
                attempt = 0
                while True:
                    # waited=False on the first pre-I/O check: a budget
                    # that was gone before we touched the peer is the
                    # QUERY's fault, not the node's
                    self._check_deadline(method, deadline,
                                         waited=attempt > 0)
                    try:
                        if self._f is None:
                            self._connect(deadline)
                        if self._sock is not None:
                            # always reset: a reused connection must not
                            # inherit the previous call's clipped timeout
                            self._sock.settimeout(
                                self._op_timeout(deadline))
                        write_frame(self._f, req.payload())
                        while True:
                            if deadline:
                                # re-check BETWEEN frames: a dripping
                                # node emitting each frame just inside
                                # the per-op timeout must still cost at
                                # most one deadline, not one timeout
                                # per streamed frame.  Tear the
                                # connection down FIRST — aborting
                                # mid-stream leaves unread frames that
                                # would poison the next (pooled) call.
                                if time.monotonic() >= deadline:
                                    self._close_locked()
                                    self._check_deadline(method,
                                                         deadline)
                                self._sock.settimeout(
                                    self._op_timeout(deadline))
                            resp = read_frame(self._f)
                            status = resp[0]
                            if status == 0:
                                if len(resp) > 1:
                                    frames.append(Reader(resp[1:]))
                                return iter(frames)
                            if status == 1:
                                # server-reported error: stream is cleanly
                                # terminated, the connection stays usable
                                msg = resp[1:].decode()
                                if msg.startswith(_SHED_PREFIX):
                                    # remote TenantGate rejection: keep
                                    # its type so the caller's 429 path
                                    # fires instead of node-down+partial
                                    raise SearchLimitError(
                                        msg[len(_SHED_PREFIX):])
                                if msg.startswith(_DEADLINE_PREFIX):
                                    # storage-side deadline abort: the
                                    # node did exactly what the shipped
                                    # budget asked — surface a typed
                                    # deadline, never mark it down
                                    _DEADLINE_EXCEEDED_TOTAL.inc()
                                    err = RPCDeadlineError(
                                        f"rpc {method} to "
                                        f"{self.addr[0]}:{self.addr[1]}: "
                                        f"{msg[len(_DEADLINE_PREFIX):]}")
                                    err.waited = False
                                    raise err
                                if msg.startswith(_RATELIMIT_PREFIX):
                                    # remote ingestion backpressure:
                                    # rebuild the typed error so the
                                    # HTTP layer's 429 + Retry-After
                                    # fires, not node-down + 500
                                    raise RateLimitedError(float(
                                        msg[len(_RATELIMIT_PREFIX):]))
                                if msg.startswith(_UNAVAIL_PREFIX):
                                    # child cluster has no live
                                    # storage: keep the 503 type
                                    raise ClusterUnavailableError(
                                        msg[len(_UNAVAIL_PREFIX):])
                                if msg.startswith(_PARTIAL_PREFIX):
                                    # child refused a partial answer:
                                    # capacity degradation, 503 type
                                    raise PartialResultError(
                                        msg[len(_PARTIAL_PREFIX):])
                                raise RPCError(msg)
                            frames.append(Reader(resp[1:]))
                    except RPCError:
                        raise
                    except TimeoutError:
                        # slow peer: tear down, surface the caller's
                        # deadline when that is what actually expired
                        self._close_locked()
                        self._check_deadline(method, deadline)
                        raise
                    except (OSError, ConnectionError):
                        self._close_locked()
                        if frames or attempt >= max_retries:
                            raise
                        attempt += 1
                        _rpc_counter("vm_rpc_client_retries_total",
                                     method).inc()
                        _RETRIES_TOTAL.inc()
                        # bounded exponential backoff with full jitter
                        delay = min(backoff_base * (2 ** (attempt - 1)),
                                    backoff_cap) * random.random()
                        if deadline:
                            remaining = deadline - time.monotonic()
                            if remaining <= 0:
                                self._check_deadline(method, deadline)
                            delay = min(delay, max(remaining, 0.0))
                        if delay > 0:
                            # the lock IS the per-connection serializer —
                            # socket ops (10s default timeout) already
                            # block under it far longer than this capped
                            # backoff, and releasing it mid-call would
                            # interleave another caller's frames onto a
                            # connection being re-dialed
                            time.sleep(delay)  # vmt: disable=VMT004 — see above
        except Exception:
            _rpc_counter("vm_rpc_client_errors_total", method).inc()
            raise
        finally:
            _rpc_histogram("vm_rpc_client_call_duration_seconds",
                           method).update(time.perf_counter() - t0)


# -- client connection pool ---------------------------------------------------

class RPCClientPool:
    """Small per-node CONNECTION pool for the select plane (the
    netstorage connPool role): concurrent queries against one storage
    node must not serialize on a single TCP connection — with one
    connection, a 300ms fetch head-of-line blocks every other query to
    that node, and the node-side TenantGate never even sees concurrent
    load to shed.

    Up to ``max_conns`` (``VM_RPC_SELECT_CONNS``, default 4) lazily
    created :class:`RPCClient` connections; callers past the cap wait
    for an idle one (bounded upstream by the HTTP concurrency gate).
    Waiting for LOCAL pool capacity is never the node's fault: a
    deadline expiring here raises ``waited=False`` so the fan-out does
    not mark the node down.  Same call/call_stream surface as
    RPCClient."""

    def __init__(self, host: str, port: int, hello: bytes,
                 timeout: float = 10.0, max_conns: int | None = None):
        if max_conns is None:
            try:
                max_conns = int(os.environ.get("VM_RPC_SELECT_CONNS",
                                               "0"))
            except ValueError:
                max_conns = 0
        if max_conns <= 0:
            max_conns = 4
        self.addr = (host, port)
        self.hello = hello
        self.timeout = timeout
        self.max_conns = max_conns
        self._lock = make_lock("rpc.RPCClientPool._lock")
        self._sem = threading.Semaphore(max_conns)
        self._idle: list[RPCClient] = []
        self._all: list[RPCClient] = []

    def _acquire(self, method: str, deadline: float) -> RPCClient:
        if deadline:
            remaining = deadline - time.monotonic()
            if remaining <= 0 or not self._sem.acquire(
                    timeout=max(remaining, 0.001)):
                _DEADLINE_EXCEEDED_TOTAL.inc()
                _rpc_counter("vm_rpc_client_deadline_exceeded_total",
                             method).inc()
                err = RPCDeadlineError(
                    f"rpc {method} to {self.addr[0]}:{self.addr[1]}: "
                    f"deadline exceeded waiting for a pooled connection")
                err.waited = False  # local capacity, not the node
                raise err
        else:
            # deadline-free (insert-path) calls still get a bounded
            # wait: all-connections-wedged must fail loudly, not hang
            if not self._sem.acquire(timeout=_acquire_cap_s()):
                _rpc_counter("vm_rpc_client_pool_exhausted_total",
                             method).inc()
                err = RPCError(
                    f"rpc {method} to {self.addr[0]}:{self.addr[1]}: no "
                    f"pooled connection freed in {_acquire_cap_s():g}s "
                    f"(pool of {self.max_conns} wedged)")
                err.waited = False  # local capacity, not the node
                raise err
        with self._lock:
            if self._idle:
                return self._idle.pop()
            c = RPCClient(self.addr[0], self.addr[1], self.hello,
                          timeout=self.timeout)
            self._all.append(c)
            return c

    def _release(self, c: RPCClient) -> None:
        with self._lock:
            self._idle.append(c)
        self._sem.release()

    def call(self, method: str, w: Writer | None = None,
             deadline: float = 0.0) -> Reader:
        c = self._acquire(method, deadline)
        try:
            return c.call(method, w, deadline=deadline)
        finally:
            self._release(c)

    def call_stream(self, method: str, w: Writer | None = None,
                    deadline: float = 0.0):
        c = self._acquire(method, deadline)
        try:
            # RPCClient reads the whole stream before returning, so the
            # connection is quiescent by the time it goes back to idle
            return c.call_stream(method, w, deadline=deadline)
        finally:
            self._release(c)

    def close(self) -> None:
        with self._lock:
            clients, self._idle = list(self._all), []
            self._all = []
        for c in clients:
            c.close()
