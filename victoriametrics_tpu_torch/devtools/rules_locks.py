"""VMT004/VMT005 — lock discipline (static half of the race tooling).

VMT004: blocking calls (sleep, sockets, HTTP, subprocess, file opens)
made while a ``with <lock>:`` block is lexically open — the whole point
of the fine-grained locks in storage/ and parallel/ is that nothing
slow runs under them.

VMT005: per-class lock-discipline inference.  If ``self.x`` is written
under ``with self._lock:`` in one method, a bare ``self.x = ...`` write
in another method of the same class is (absent an inline justification)
a data race.  ``__init__`` and ``*_locked`` helper methods (callers
hold the lock by convention) are exempt.

Both rules treat any context-manager expression whose last attribute
looks lock-ish (``*lock*``, ``*mutex*``, ``mu``/``*_mu``) as a lock —
the project naming convention makes this reliable.

The port's copy of ``victoriametrics_tpu/devtools/rules_locks.py``,
whole.
"""

from __future__ import annotations

import ast

from .lint import dotted_name

_FUNC_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)

_BLOCKING_EXACT = {"time.sleep", "_time.sleep"}
_BLOCKING_PREFIXES = ("socket.", "requests.", "subprocess.",
                      "urllib.request.", "http.client.")
_BLOCKING_BUILTINS = {"open"}


def lockish_name(expr) -> str | None:
    """Dotted name of a lock-looking expression, else None."""
    name = dotted_name(expr)
    if name is None:
        return None
    last = name.split(".")[-1].lower()
    if "lock" in last or "mutex" in last or last in ("mu", "_mu") or \
            last.endswith("_mu"):
        return name
    return None


def _with_locks(node: ast.With | ast.AsyncWith) -> list[str]:
    out = []
    for item in node.items:
        name = lockish_name(item.context_expr)
        if name:
            out.append(name)
    return out


def _is_blocking_call(call: ast.Call) -> str | None:
    name = dotted_name(call.func)
    if name is None:
        return None
    if name in _BLOCKING_EXACT or name in _BLOCKING_BUILTINS or \
            name.startswith(_BLOCKING_PREFIXES):
        return name
    return None


class BlockingUnderLockRule:
    rule_id = "VMT004"
    summary = "blocking call while a 'with <lock>:' block is open"

    def check(self, ctx):
        yield from self._walk(ctx, ctx.tree, [])

    def _walk(self, ctx, node, held: list[str]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _FUNC_SCOPES + (ast.ClassDef,)):
                # nested defs execute later, outside this lock region
                yield from self._walk(ctx, child, [])
                continue
            if isinstance(child, (ast.With, ast.AsyncWith)):
                yield from self._walk(ctx, child,
                                      held + _with_locks(child))
                continue
            if held and isinstance(child, ast.Call):
                name = _is_blocking_call(child)
                if name:
                    yield ctx.finding(
                        child, self.rule_id,
                        f"blocking call {name}() while holding "
                        f"{held[-1]}; move the slow work outside the "
                        f"critical section")
            yield from self._walk(ctx, child, held)


class _AttrWrites(ast.NodeVisitor):
    """Collect self.<attr> writes in one method, split by lock depth."""

    def __init__(self):
        self.guarded: list[tuple[str, ast.AST]] = []
        self.bare: list[tuple[str, ast.AST]] = []
        self._depth = 0

    def _record(self, target):
        if isinstance(target, ast.Attribute) and \
                isinstance(target.value, ast.Name) and \
                target.value.id == "self":
            dest = self.guarded if self._depth else self.bare
            dest.append((target.attr, target))

    def visit_Assign(self, node):
        for t in node.targets:
            self._record(t)
            if isinstance(t, ast.Tuple):
                for el in t.elts:
                    self._record(el)
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        self._record(node.target)
        self.generic_visit(node)

    def visit_AnnAssign(self, node):
        self._record(node.target)
        self.generic_visit(node)

    def visit_With(self, node):
        locks = _with_locks(node)
        self._depth += bool(locks)
        for stmt in node.body:
            self.visit(stmt)
        self._depth -= bool(locks)

    visit_AsyncWith = visit_With

    def visit_FunctionDef(self, node):
        # nested defs run later, with or without the lock — unknowable
        # statically, so their writes count as neither guarded nor bare
        pass

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef


class LockDisciplineRule:
    rule_id = "VMT005"
    summary = "bare write to a field guarded by a lock elsewhere"

    def check(self, ctx):
        for cls in ast.walk(ctx.tree):
            if isinstance(cls, ast.ClassDef):
                yield from self._check_class(ctx, cls)

    def _check_class(self, ctx, cls: ast.ClassDef):
        per_method: dict[str, _AttrWrites] = {}
        for stmt in cls.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                w = _AttrWrites()
                for s in stmt.body:
                    w.visit(s)
                per_method[stmt.name] = w

        guarded_attrs = set()
        for name, w in per_method.items():
            if name != "__init__":
                guarded_attrs.update(a for a, _ in w.guarded)
        # the locks themselves are assigned bare in __init__ by design
        guarded_attrs = {a for a in guarded_attrs
                         if lockish_name(ast.Name(id=a)) is None}
        if not guarded_attrs:
            return

        for name, w in per_method.items():
            if name == "__init__" or name.endswith("_locked"):
                continue
            for attr, node in w.bare:
                if attr in guarded_attrs:
                    yield ctx.finding(
                        node, self.rule_id,
                        f"self.{attr} is written under a lock elsewhere "
                        f"in {cls.name} but bare here; take the lock, "
                        f"rename the method *_locked, or justify with an "
                        f"inline disable")


RULES = [BlockingUnderLockRule(), LockDisciplineRule()]
