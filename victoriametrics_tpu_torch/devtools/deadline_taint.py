"""VMT012 — deadline-taint pass over the whole-program call graph.

Query deadlines are a *dynamic* property: the select plane clips
every RPC socket op to the remaining budget and vmstorage aborts
mid-scan via :class:`utils.deadline.Budget`.  This pass makes the
complementary invariant *static*: *no blocking primitive is reachable
from a serving entry point except through a deadline-aware seam*.

Entry points (discovered, not hardcoded):

- HTTP handlers — every ``srv.route(path, fn)`` registration, including
  the ``r = srv.route`` alias idiom and lambda handlers.  Operator/debug
  surfaces (``/internal/``, ``/debug/``) are out of scope: they are
  invoked by humans running diagnostics, and e.g. the pprof profile
  handler's bounded capture sleep is its contract, not a bug.
- RPC server dispatch — the ``make_storage_handlers`` dict: every value
  under a ``*_v<N>`` string key.
- Matstream advance — ``MatStream._advance`` /
  ``MatStreamRegistry.advance_due`` run per-subscription evaluation on
  pool workers with live readers waiting on the push queue.

Blocking primitives flagged when reachable without a seam:
``time.sleep``; raw socket ``recv/recv_into/accept/connect/sendall``
and ``create_connection``/``urlopen`` without a timeout; ``queue.get()``
with neither timeout nor ``block=False``; queue ``put()`` without
timeout; ``Future.result()`` that does NOT resolve to the workpool's
help-draining future; zero-arg ``.join()``; ``.wait()`` without
timeout; and semaphore/gate ``.acquire()`` without timeout.

Plain mutex ``lock.acquire()`` is deliberately NOT flagged: short
critical sections are the locking discipline VMT004/VMT005 and the
locktrace hold-time tracer already police, and timing out a mutex would
turn every lock site into an error path.  Semaphores are different —
they model *capacity*, can be held across I/O for seconds, and a full
pool plus a dead peer means an unbounded stall, which is exactly the
hang this pass exists to prevent.

Seams (the BFS does not descend into them):

- ``utils/workpool.py`` — admission gates and ``Future.result`` help
  drain: a waiter executes queued work instead of parking, and the
  submitted units carry their own ``Budget`` checks.
- ``utils/deadline.py`` — the budget itself.
- any function that calls ``.settimeout(X)`` with a non-None ``X`` —
  the RPC client's per-op socket-deadline clipping idiom.  A function
  that re-arms the socket timeout around its reads IS the wrapper this
  pass wants everything else to go through.

Findings are real bugs, not style: they get fixed, never baselined.
``# vmt: disable=VMT012`` on the blocking line is honored for the rare
sanctioned case (with the consumed-suppression set reported so VMT013
can spot stale ones).

The port's copy of ``victoriametrics_tpu/devtools/deadline_taint.py``,
whole.
"""

from __future__ import annotations

import argparse
import ast
import os
import re
import sys

from .callgraph import CallGraph, build_callgraph
from .lint import _SUPPRESS_RE, Finding

RULE_ID = "VMT012"

#: modules that ARE the deadline/admission machinery — descending into
#: them would flag the implementation of the very seams we require
SEAM_MODULES = (
    "victoriametrics_tpu_torch/utils/workpool.py",
    "victoriametrics_tpu_torch/utils/deadline.py",
)

#: route prefixes excluded from the serving entry set (operator/debug
#: surfaces; see module docstring)
EXCLUDED_ROUTE_PREFIXES = ("/internal/", "/debug/")

_RPC_METHOD_RE = re.compile(r"_v\d+$")


# -- entry discovery --------------------------------------------------------

def _lambda_qname(g: CallGraph, rel: str, lineno: int) -> str | None:
    suffix = f"<lambda@{lineno}>"
    for q in g.defs:
        if q.startswith(rel + "::") and q.endswith(suffix):
            return q
    return None


def find_entries(g: CallGraph) -> dict[str, str]:
    """qname -> human-readable entry description."""
    entries: dict[str, str] = {}

    class _RouteFinder(ast.NodeVisitor):
        def __init__(self, rel):
            self.rel = rel
            self.cls_q = None
            self.aliases: set[str] = set()   # local names bound to .route

        def visit_ClassDef(self, node):
            prev, self.cls_q = self.cls_q, f"{self.rel}::{node.name}"
            self.generic_visit(node)
            self.cls_q = prev

        def visit_Assign(self, node):
            v = node.value
            if isinstance(v, ast.Attribute) and v.attr == "route":
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.aliases.add(t.id)
            self.generic_visit(node)

        def visit_Call(self, node):
            f = node.func
            is_route = (isinstance(f, ast.Attribute) and
                        f.attr == "route") or \
                       (isinstance(f, ast.Name) and f.id in self.aliases)
            if is_route and len(node.args) >= 2 and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str):
                path = node.args[0].value
                if not path.startswith(EXCLUDED_ROUTE_PREFIXES):
                    self._add(path, node.args[1])
            self.generic_visit(node)

        def _add(self, path, handler):
            q = None
            if isinstance(handler, ast.Attribute) and \
                    isinstance(handler.value, ast.Name) and \
                    handler.value.id == "self" and self.cls_q:
                q = g.class_method(self.cls_q, handler.attr)
            elif isinstance(handler, ast.Name):
                q = g.lookup(self.rel, handler.id)
            elif isinstance(handler, ast.Lambda):
                q = _lambda_qname(g, self.rel, handler.lineno)
            if q is not None:
                entries.setdefault(q, f"http {path}")

    for rel, tree in g.module_trees.items():
        _RouteFinder(rel).visit(tree)
        # RPC dispatch dicts: {"search_v1": h_search, ...}
        for node in ast.walk(tree):
            if not isinstance(node, ast.Dict):
                continue
            keyed = [(k, v) for k, v in zip(node.keys, node.values)
                     if isinstance(k, ast.Constant) and
                     isinstance(k.value, str) and
                     _RPC_METHOD_RE.search(k.value)]
            if len(keyed) < 3:
                continue
            for k, v in keyed:
                if not isinstance(v, ast.Name):
                    continue
                for q in g.by_name.get(v.id, ()):
                    fd = g.defs[q]
                    if fd.rel_path == rel and \
                            abs(fd.lineno - node.lineno) < 2000:
                        entries.setdefault(q, f"rpc {k.value}")
                        break

    # matstream advance: subscription evaluation with readers waiting
    for cls, meth in (("MatStream", "_advance"),
                      ("MatStreamRegistry", "advance_due")):
        for rel in g.module_trees:
            q = g.class_method(f"{rel}::{cls}", meth)
            if q is not None:
                entries.setdefault(q, f"matstream {cls}.{meth}")
    return entries


# -- seams ------------------------------------------------------------------

def _sets_socket_timeout(fd) -> bool:
    if isinstance(fd.node, ast.Lambda):
        return False
    for node in ast.walk(fd.node):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "settimeout" and node.args:
            a = node.args[0]
            if not (isinstance(a, ast.Constant) and a.value is None):
                return True
    return False


def find_seams(g: CallGraph) -> set[str]:
    seams = set()
    for q, fd in g.defs.items():
        if fd.rel_path in SEAM_MODULES or _sets_socket_timeout(fd):
            seams.add(q)
    return seams


# -- blocking-primitive detection -------------------------------------------

def _kw(node, name):
    for kw in node.keywords:
        if kw.arg == name:
            return kw
    return None


def _has_timeout(node) -> bool:
    return _kw(node, "timeout") is not None


def _receiver_name(func) -> str:
    """Last segment of the receiver expression of an Attribute call."""
    v = func.value
    while isinstance(v, ast.Attribute):
        return v.attr
    return v.id if isinstance(v, ast.Name) else ""


def _own_nodes(fd):
    """The function's own statements, nested defs excluded (they are
    separate graph nodes, reached only if actually invoked)."""
    body = [fd.node.body] if isinstance(fd.node, ast.Lambda) \
        else list(fd.node.body)
    stack = body
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


#: method-shaped primitives eligible for project-resolution bypass: when
#: the receiver resolves to a project class defining the method, the BFS
#: already descends into that method's body — the name is not the
#: stdlib primitive (PersistentQueue.put appends to disk; Counter.get
#: reads a value under a mutex)
_METHOD_PRIMS = ("get", "put", "result", "join", "wait", "acquire")


def _project_resolved(g: CallGraph, fd, f) -> bool:
    """True when ``f`` (an Attribute callee) resolves through the graph
    to a project-defined method: ``self.m()`` via the enclosing class,
    ``self.attr.m()`` via __init__ constructor type hints."""
    v = f.value
    if isinstance(v, ast.Name) and v.id == "self" and fd.cls:
        cls_q = f"{fd.rel_path}::{fd.cls}"
        return g.class_method(cls_q, f.attr) is not None
    if isinstance(v, ast.Attribute) and \
            isinstance(v.value, ast.Name) and v.value.id == "self" and \
            fd.cls:
        cls_q = f"{fd.rel_path}::{fd.cls}"
        t = g._attr_types.get(cls_q, {}).get(v.attr)
        return t is not None and g.class_method(t, f.attr) is not None
    return False


def _submit_futures(fd) -> set[str]:
    """Local names assigned from ``<pool>.submit(...)`` — workpool
    futures whose ``result()`` helps drain the queue (bounded progress,
    and the submitted units carry their own Budget checks)."""
    futures: set[str] = set()
    for node in _own_nodes(fd):
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Call) and \
                isinstance(node.value.func, ast.Attribute) and \
                node.value.func.attr == "submit":
            for t in node.targets:
                if isinstance(t, ast.Name):
                    futures.add(t.id)
    return futures


def blocking_calls(fd, g: CallGraph, seams: set[str]):
    """Yield (lineno, description) for unbounded blocking primitives in
    this function's own body."""
    pool_futures = _submit_futures(fd)
    for node in _own_nodes(fd):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        name = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else "")
        if not name:
            continue
        if name in _METHOD_PRIMS and isinstance(f, ast.Attribute) and \
                _project_resolved(g, fd, f):
            continue  # resolves to project code the BFS walks itself
        if name == "sleep":
            yield node.lineno, "time.sleep() (unconditional wall-clock stall)"
        elif name in ("recv", "recv_into", "accept", "connect", "sendall") \
                and isinstance(f, ast.Attribute):
            yield node.lineno, (f"socket .{name}() outside a "
                                "settimeout-clipping wrapper")
        elif name in ("create_connection", "urlopen") and \
                not _has_timeout(node):
            yield node.lineno, f"{name}() without timeout="
        elif name == "get" and isinstance(f, ast.Attribute) and \
                not node.args and not _has_timeout(node) and \
                _kw(node, "block") is None:
            yield node.lineno, "queue .get() without timeout"
        elif name == "put" and isinstance(f, ast.Attribute) and \
                not _has_timeout(node) and _kw(node, "block") is None and \
                "queue" in _receiver_name(f).lower():
            yield node.lineno, "queue .put() without timeout"
        elif name == "result" and isinstance(f, ast.Attribute) and \
                not node.args and not _has_timeout(node) and \
                not (isinstance(f.value, ast.Name) and
                     f.value.id in pool_futures):
            yield node.lineno, ".result() without timeout on an unresolved future"
        elif name == "join" and isinstance(f, ast.Attribute) and \
                not node.args and not _has_timeout(node):
            yield node.lineno, "zero-arg .join() (unbounded thread/queue wait)"
        elif name == "wait" and isinstance(f, ast.Attribute) and \
                not node.args and not _has_timeout(node):
            yield node.lineno, ".wait() without timeout"
        elif name == "acquire" and isinstance(f, ast.Attribute) and \
                not node.args and not _has_timeout(node):
            recv = _receiver_name(f).lower()
            if "sem" in recv or "gate" in recv:
                yield node.lineno, (f"semaphore {_receiver_name(f)}"
                                    ".acquire() without timeout")


# -- the pass ---------------------------------------------------------------

def run_pass(g: CallGraph | None = None, paths=None):
    """Returns (findings, used_suppressions) where used_suppressions is
    ``{rel_path: {(line, RULE_ID), ...}}`` for VMT013's bookkeeping."""
    if g is None:
        g = build_callgraph(paths or _default_paths())
    entries = find_entries(g)
    seams = find_seams(g)

    # BFS with parent pointers so findings carry a witness path
    parent: dict[str, tuple[str | None, str]] = {}
    order = []
    for q, why in entries.items():
        if q in g.defs and q not in seams and q not in parent:
            parent[q] = (None, why)
            order.append(q)
    i = 0
    while i < len(order):
        q = order[i]
        i += 1
        for e in g.callees(q):
            t = e.target
            if t not in parent and t not in seams and t in g.defs:
                parent[t] = (q, parent[q][1])
                order.append(t)

    def witness(q: str) -> tuple[str, str]:
        chain = []
        cur: str | None = q
        while cur is not None:
            chain.append(g.defs[cur].name if g.defs.get(cur) else cur)
            cur = parent[cur][0]
        chain.reverse()
        entry_why = parent[q][1]
        if len(chain) > 5:
            chain = chain[:2] + ["..."] + chain[-2:]
        return entry_why, " -> ".join(chain)

    findings: list[Finding] = []
    used: dict[str, set[tuple[int, str]]] = {}
    seen_sites = set()
    for q in order:
        fd = g.defs[q]
        for lineno, what in blocking_calls(fd, g, seams):
            site = (fd.rel_path, lineno)
            if site in seen_sites:
                continue
            seen_sites.add(site)
            if _suppressed(g, fd.rel_path, lineno):
                used.setdefault(fd.rel_path, set()).add((lineno, RULE_ID))
                continue
            entry_why, path = witness(q)
            findings.append(Finding(
                fd.rel_path, lineno, RULE_ID,
                f"{what} reachable from serving entry [{entry_why}] "
                f"via {path}"))
    findings.sort(key=lambda f: (f.path, f.line))
    # a disable comment on a blocking site OUTSIDE the reachable set
    # still guards a real primitive — mark it consumed so VMT013 only
    # flags comments whose primitive vanished, not ones whose def
    # merely fell out of the entry closure
    reached = set(order)
    for q, fd in g.defs.items():
        if q in reached:
            continue
        for lineno, _what in blocking_calls(fd, g, seams):
            if _suppressed(g, fd.rel_path, lineno):
                used.setdefault(fd.rel_path, set()).add((lineno, RULE_ID))
    return findings, used


def _suppressed(g: CallGraph, rel: str, lineno: int) -> bool:
    src = g.sources.get(rel)
    if src is None:
        return False
    lines = src.splitlines()
    if not (1 <= lineno <= len(lines)):
        return False
    m = _SUPPRESS_RE.search(lines[lineno - 1])
    return bool(m) and RULE_ID in {
        s.strip().upper() for s in m.group(1).split(",")}


def _default_paths():
    from .lint import REPO_ROOT
    return [os.path.join(REPO_ROOT, "victoriametrics_tpu_torch")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m victoriametrics_tpu_torch.devtools.deadline_taint",
        description="VMT012: blocking primitives reachable from serving "
                    "entry points without a deadline-aware seam.")
    ap.add_argument("paths", nargs="*")
    ap.add_argument("--list-entries", action="store_true")
    ap.add_argument("--list-seams", action="store_true")
    args = ap.parse_args(argv)

    g = build_callgraph(args.paths or _default_paths())
    if args.list_entries:
        for q, why in sorted(find_entries(g).items(),
                             key=lambda kv: kv[1]):
            print(f"{why:40s} {q}")
        return 0
    if args.list_seams:
        for q in sorted(find_seams(g)):
            print(q)
        return 0
    findings, _ = run_pass(g)
    for f in findings:
        print(f)
    if findings:
        print(f"\n{len(findings)} deadline-taint finding(s): fix them "
              f"(these are real hangs waiting for a slow peer), do not "
              f"baseline them.", file=sys.stderr)
        return 1
    print(f"deadline-taint clean: {len(find_entries(g))} entries, "
          f"{len(g.defs)} defs analyzed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
