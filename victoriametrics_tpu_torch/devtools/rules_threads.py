"""VMT008/VMT009/VMT010/VMT011 — thread-lifecycle and queue discipline
(the static companions of devtools/racetrace).

VMT008: a ``threading.Thread(...)`` constructed without ``daemon=True``
in a scope that never ``join()``s anything and never sets ``.daemon`` —
such a thread outlives shutdown silently (a non-daemon thread blocks
interpreter exit; a daemonless never-joined worker leaks).

VMT009: cross-object writes to a field the lock-discipline pass (the
VMT005 inference) proved lock-guarded inside its own class.  VMT005
catches ``self.x = ...`` in the owning class; this rule catches
``other.x = ...`` from the outside, performed while no ``with <lock>:``
block is lexically open.

VMT010: a ``queue.Queue`` ``get``/``put`` carrying ``timeout=`` (or
``block=False``) inside a ``try`` whose ``queue.Empty``/``queue.Full``
handler is only ``pass`` — the timeout fires, the signal is dropped,
and starvation/backpressure becomes invisible.  Handle it: log, break,
re-check a stop flag, or count it.

VMT011: direct ``threading.Thread(...)`` construction outside
``devtools/`` and ``apps/`` — hot-path code must go through the shared
work pool (``utils/workpool``), which bounds thread count at
``cpu_count``, preserves result order, carries the racetrace
happens-before seam, and honors ``VM_SEARCH_WORKERS=1``.  Long-lived
service threads (servers, flush loops) are grandfathered via the
baseline or an inline disable with a reason.

The port's copy of ``victoriametrics_tpu/devtools/rules_threads.py``,
whole.
"""

from __future__ import annotations

import ast

from .lint import dotted_name
from .rules_locks import _AttrWrites, _with_locks, lockish_name

_FUNC_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef)


def _is_thread_ctor(call: ast.Call) -> bool:
    name = dotted_name(call.func)
    return name is not None and \
        (name == "Thread" or name.endswith(".Thread"))


class UnjoinedThreadRule:
    rule_id = "VMT008"
    summary = "Thread(...) started without daemon=True or a join()"

    def check(self, ctx):
        # scopes: each function plus the module body, examined separately
        scopes = [ctx.tree] + [n for n in ast.walk(ctx.tree)
                               if isinstance(n, _FUNC_SCOPES)]
        for scope in scopes:
            yield from self._check_scope(ctx, scope)

    def _scope_nodes(self, scope):
        """Nodes belonging to this scope, not to nested functions."""
        stack = list(ast.iter_child_nodes(scope))
        while stack:
            node = stack.pop()
            if isinstance(node, _FUNC_SCOPES + (ast.Lambda,)):
                continue
            yield node
            stack.extend(ast.iter_child_nodes(node))

    def _check_scope(self, ctx, scope):
        threads = []
        joins_or_daemonizes = False
        for node in self._scope_nodes(scope):
            if isinstance(node, ast.Call):
                if _is_thread_ctor(node):
                    if any(kw.arg == "daemon" for kw in node.keywords):
                        continue        # explicit daemon choice
                    threads.append(node)
                elif isinstance(node.func, ast.Attribute) and \
                        node.func.attr == "join" and \
                        not isinstance(node.func.value, ast.Constant):
                    # .join on a string literal is str.join, not a thread
                    joins_or_daemonizes = True
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Attribute) and t.attr == "daemon":
                        joins_or_daemonizes = True
        if joins_or_daemonizes:
            return                      # coarse: any join/daemon= in scope
        for call in threads:
            yield ctx.finding(
                call, self.rule_id,
                "Thread(...) without daemon=True in a scope with no "
                "join(); shutdown will either hang on it or leak it — "
                "pass daemon=True or join it")


class CrossObjectGuardedWriteRule:
    rule_id = "VMT009"
    summary = "write to a lock-guarded field of another object, no lock held"

    def check(self, ctx):
        guarded = self._guarded_attrs(ctx)
        if not guarded:
            return
        scopes = [n for n in ast.walk(ctx.tree)
                  if isinstance(n, _FUNC_SCOPES)
                  and not n.name.endswith("_locked")]
        for scope in scopes:
            yield from self._walk(ctx, scope, guarded, held=False)

    def _guarded_attrs(self, ctx) -> set[str]:
        """Fields some class in this file writes only under a lock — the
        same inference VMT005 runs, reused across class boundaries."""
        guarded: set[str] = set()
        for cls in ast.walk(ctx.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            for stmt in cls.body:
                if isinstance(stmt, _FUNC_SCOPES) and stmt.name != "__init__":
                    w = _AttrWrites()
                    for s in stmt.body:
                        w.visit(s)
                    guarded.update(a for a, _ in w.guarded)
        return {a for a in guarded
                if lockish_name(ast.Name(id=a)) is None}

    def _walk(self, ctx, node, guarded, held):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _FUNC_SCOPES + (ast.Lambda, ast.ClassDef)):
                continue                # nested scopes checked separately
            if isinstance(child, (ast.With, ast.AsyncWith)):
                yield from self._walk(ctx, child, guarded,
                                      held or bool(_with_locks(child)))
                continue
            if not held and isinstance(child, (ast.Assign, ast.AugAssign)):
                targets = child.targets if isinstance(child, ast.Assign) \
                    else [child.target]
                for t in targets:
                    if isinstance(t, ast.Attribute) and \
                            t.attr in guarded and \
                            not (isinstance(t.value, ast.Name) and
                                 t.value.id == "self"):
                        yield ctx.finding(
                            t, self.rule_id,
                            f".{t.attr} is lock-guarded inside its own "
                            f"class but written here from outside with no "
                            f"lock held; go through a method that takes "
                            f"the owner's lock")
            yield from self._walk(ctx, child, guarded, held)


_QUEUE_EXCS = {"Empty", "Full"}


def _has_timeout_queue_op(try_body) -> bool:
    for stmt in try_body:
        for node in ast.walk(stmt):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("get", "put")):
                continue
            for kw in node.keywords:
                if kw.arg == "timeout":
                    return True
                if kw.arg == "block" and \
                        isinstance(kw.value, ast.Constant) and \
                        kw.value.value is False:
                    return True
    return False


def _body_is_pass(body) -> bool:
    return all(isinstance(s, ast.Pass) or
               (isinstance(s, ast.Expr) and isinstance(s.value, ast.Constant)
                and s.value.value is Ellipsis)
               for s in body)


class SwallowedQueueTimeoutRule:
    rule_id = "VMT010"
    summary = "queue get/put timeout whose Empty/Full is silently swallowed"

    def check(self, ctx):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Try):
                continue
            if not _has_timeout_queue_op(node.body):
                continue
            for handler in node.handlers:
                if handler.type is None:
                    continue            # bare except is VMT003's business
                names = set()
                nodes = handler.type.elts \
                    if isinstance(handler.type, ast.Tuple) \
                    else [handler.type]
                for n in nodes:
                    dn = dotted_name(n)
                    if dn:
                        names.add(dn.split(".")[-1])
                if names & _QUEUE_EXCS and _body_is_pass(handler.body):
                    yield ctx.finding(
                        handler, self.rule_id,
                        "queue timeout expired and its Empty/Full was "
                        "swallowed with 'pass'; starvation becomes "
                        "invisible — log it, break, or re-check the stop "
                        "flag explicitly")


class DirectThreadRule:
    rule_id = "VMT011"
    summary = "threading.Thread(...) outside devtools//apps/ (use workpool)"

    #: path fragments where direct Thread construction is legitimate:
    #: dev tooling (schedulers, harnesses) and app entry points (servers)
    _EXEMPT = ("devtools/", "apps/")

    def check(self, ctx):
        rel = ctx.rel_path.replace("\\", "/")
        if any(frag in rel for frag in self._EXEMPT):
            return
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call) and _is_thread_ctor(node):
                yield ctx.finding(
                    node, self.rule_id,
                    "direct threading.Thread(...) on a non-devtools/apps "
                    "path; hot-path fan-out must go through "
                    "utils.workpool.POOL (bounded, ordered, racetrace-"
                    "aware, VM_SEARCH_WORKERS-gated) — long-lived service "
                    "threads need a '# vmt: disable=VMT011' with a reason "
                    "or a baseline entry")


RULES = [UnjoinedThreadRule(), CrossObjectGuardedWriteRule(),
         SwallowedQueueTimeoutRule(), DirectThreadRule()]
