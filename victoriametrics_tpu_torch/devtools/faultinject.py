"""Fault-injection seams for chaos testing.

The chaos harness (``tests/test_chaos_cluster.py``, ``tools/chaos.sh``)
needs the cluster to misbehave ON DEMAND: slow nodes, stalled RPCs,
connection resets, injected error returns.  This module is the single
seam — production code calls :func:`fire` at a handful of well-known
points and pays one attribute read when no faults are armed.

Fault points currently wired:

- ``rpc:<method>`` — the RPC server dispatch (parallel/rpc.py), fired
  after the method name is parsed and before the handler runs.  A
  ``reset`` here closes the connection without a response frame (the
  client sees a mid-frame close); ``delay``/``stall`` hold the
  connection thread so the client's socket deadline trips.
- ``storage:search:<accountID>:<projectID>`` — the storage engine's
  search entry (storage/storage.py), fired INSIDE the TenantGate slot
  so an injected delay occupies real admission capacity (how the QoS
  chaos scenario saturates one tenant without touching another).
- ``storage:scan`` — the storage-side deadline budget check (fired at
  every Budget check while a deadline-carrying search runs): a
  ``delay`` here dilates the scan so a chaos run can prove a query
  aborts within ~one check interval of its budget expiring.
- Crashpoints in the part lifecycle (the kill -9 recovery matrix,
  tools/chaos.sh): ``part:finalize:pre_rename``,
  ``part:finalize:post_rename``, ``partition:parts_json:pre_replace``,
  ``merge:post_rename_pre_manifest``, ``mergeset:flush``,
  ``indexdb:rotate``, ``snapshot:mid``.  Armed with the ``crash``
  action they hard-kill the process (``os._exit``) at that instant, so
  a subprocess harness can die at every interesting point of the
  write-to-tmp -> fsync -> rename discipline and assert clean reopen.

Spec grammar (``VM_FAULTS`` env var at process start, or swapped live
over HTTP via ``/internal/faults?set=...``)::

    spec    := entry (';' entry)*
    entry   := point '=' action [':' param [':' probability]]
    action  := 'delay' | 'stall' | 'error' | 'reset' | 'crash'

``point`` may end in ``*`` for a prefix match (``rpc:*`` hits every
RPC method; ``storage:search:*`` every tenant).  ``param`` is the
sleep in ms for ``delay``/``stall`` (stall defaults to 300000 —
"forever" at query timescales) and the exit code for ``crash``
(default 86, the harness's "died at an armed crashpoint" signature);
probability defaults to 1.0.

Examples::

    VM_FAULTS='rpc:searchColumns_v1=delay:500'        # slow node
    VM_FAULTS='rpc:*=reset::0.3'                      # flaky transport
    VM_FAULTS='storage:search:1:0=delay:300'          # one slow tenant
    VM_FAULTS='part:finalize:pre_rename=crash'        # kill -9 mid-flush
    VM_FAULTS='merge:*=crash::0.25'                   # randomized crash

Injections count into ``vm_fault_injections_total{point=,action=}`` so
a chaos run can assert its faults actually fired.

The port's copy of ``victoriametrics_tpu/devtools/faultinject.py``, whole.
"""

from __future__ import annotations

import os
import random
import threading
import time

from ..utils import metrics as metricslib

__all__ = ["ConnectionAbort", "InjectedError", "configure", "spec",
           "fire", "active", "http_enabled", "handle_http"]


class InjectedError(RuntimeError):
    """Injected handler failure: surfaces as a normal error response."""


class ConnectionAbort(Exception):
    """Injected connection reset: the transport must drop the peer
    without a response (NOT an error frame — the point is to exercise
    the client's reconnect path, not its error path)."""


_ACTIONS = ("delay", "stall", "error", "reset", "crash")

#: exit code for an armed ``crash`` action (overridable per entry via the
#: param field): distinctive enough that the recovery harness can tell
#: "died at the crashpoint" from an ordinary failure
CRASH_EXIT_CODE = 86


class _Fault:
    __slots__ = ("point", "action", "param_ms", "prob")

    def __init__(self, point: str, action: str, param_ms: float,
                 prob: float):
        self.point = point
        self.action = action
        self.param_ms = param_ms
        self.prob = prob

    def matches(self, point: str) -> bool:
        if self.point.endswith("*"):
            return point.startswith(self.point[:-1])
        return point == self.point

    def __str__(self) -> str:
        s = f"{self.point}={self.action}:{self.param_ms:g}"
        if self.prob < 1.0:
            s += f":{self.prob:g}"
        return s


_lock = threading.Lock()
_faults: list[_Fault] = []
#: fast-path guard: fire() reads this one attribute when nothing is armed
_armed = False

_metric_memo: dict[tuple, object] = {}


def _injections(point: str, action: str):
    key = (point, action)
    m = _metric_memo.get(key)
    if m is None:
        # benign double-create: REGISTRY.counter dedups by name, so two
        # racing fills store the same object
        m = _metric_memo[key] = metricslib.REGISTRY.counter(  # vmt: disable=VMT015
            metricslib.format_name("vm_fault_injections_total",
                                   {"point": point, "action": action}))
    return m


def parse(raw: str) -> list[_Fault]:
    """Parse a fault spec; raises ValueError with a pointed message on a
    malformed entry (the HTTP toggle surfaces it as a 400)."""
    out: list[_Fault] = []
    for entry in raw.replace("\n", ";").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        point, eq, rhs = entry.partition("=")
        point = point.strip()
        if not eq or not point:
            raise ValueError(f"bad fault entry {entry!r} "
                             f"(want point=action[:ms[:prob]])")
        parts = rhs.strip().split(":")
        action = parts[0]
        if action not in _ACTIONS:
            raise ValueError(f"unknown fault action {action!r} "
                             f"(want one of {', '.join(_ACTIONS)})")
        param_ms = 300_000.0 if action == "stall" else \
            float(CRASH_EXIT_CODE) if action == "crash" else 0.0
        prob = 1.0
        if len(parts) > 1 and parts[1]:
            param_ms = float(parts[1])
        if len(parts) > 2 and parts[2]:
            prob = float(parts[2])
        if len(parts) > 3:
            raise ValueError(f"bad fault entry {entry!r}: too many fields")
        out.append(_Fault(point, action, param_ms, prob))
    return out


def configure(raw: str) -> None:
    """Replace the armed fault table ('' clears everything)."""
    global _armed
    faults = parse(raw)
    with _lock:
        _faults[:] = faults
        _armed = bool(faults)


def spec() -> str:
    """The armed fault table, re-serialized to the spec grammar."""
    with _lock:
        return ";".join(str(f) for f in _faults)


def active() -> bool:
    return _armed


def fire(point: str) -> None:
    """Trip any armed fault matching `point`.  No-op (one attribute
    read) unless faults are configured."""
    if not _armed:
        return
    with _lock:
        matched = [f for f in _faults if f.matches(point)]
    for f in matched:
        if f.prob < 1.0 and random.random() >= f.prob:
            continue
        _injections(f.point, f.action).inc()
        if f.action in ("delay", "stall"):
            # the injected stall IS the configured fault: an operator
            # armed VM_FAULTS to model exactly this hang
            time.sleep(f.param_ms / 1e3)  # vmt: disable=VMT012
        elif f.action == "error":
            # chaos tool: the anonymous 500/error frame IS the injected
            # failure mode the harness asserts on — never map it
            raise InjectedError(  # vmt: disable=VMT016
                f"injected fault at {point} (devtools/faultinject)")
        elif f.action == "reset":
            # models a peer dropping the TCP connection mid-call; on an
            # HTTP-reachable point the resulting 500 is the modeled fault
            raise ConnectionAbort(  # vmt: disable=VMT016
                f"injected connection reset at {point}")
        elif f.action == "crash":
            # hard kill, NOW: no atexit, no finally blocks, no flusher
            # shutdown — the whole point is to model kill -9 at this
            # exact instant.  Write the marker line unbuffered so the
            # recovery harness can attribute the death.
            try:
                os.write(2, f"faultinject: CRASH at {point}\n".encode())
            except OSError:
                pass
            os._exit(int(f.param_ms) or CRASH_EXIT_CODE)


def http_enabled() -> bool:
    """Whether the live ``/internal/faults`` toggle may mutate the
    table.  Opt-in only — a production process must not be stallable by
    one unauthenticated HTTP request: enabled when ``VM_FAULT_INJECT``
    is truthy (re-read per request) or a fault table was armed from
    ``VM_FAULTS`` at process start (the process already consented to
    chaos)."""
    return os.environ.get("VM_FAULT_INJECT", "") not in ("", "0") \
        or bool(_env_spec)


def handle_http(req, response_cls):
    """The shared ``/internal/faults`` handler (vmstorage's bare HTTP
    server and PrometheusAPI both route here): GET lists the armed
    table, ``?set=<spec>`` replaces it, ``?clear=1`` disarms; 403
    unless :func:`http_enabled`."""
    if not http_enabled():
        return response_cls.error(
            "fault injection disabled (start the process with "
            "VM_FAULT_INJECT=1 or VM_FAULTS set to enable the live "
            "toggle)", 403, "forbidden")
    if req.arg("clear") == "1":
        configure("")
    elif "set" in req.query:
        try:
            configure(req.arg("set"))
        except ValueError as e:
            return response_cls.error(f"bad fault spec: {e}", 400)
    return response_cls.json({"status": "ok", "faults": spec()})


# arm from the environment at import so subprocess apptests configure
# faults without an HTTP round trip (AppProc passes env overrides)
_env_spec = os.environ.get("VM_FAULTS", "")
if _env_spec:
    try:
        configure(_env_spec)
    except ValueError:
        # a typo in the env must not brick the process at import; the
        # operator sees the empty table via /internal/faults
        pass
