"""Project-wide AST-derived call graph (the whole-program substrate the
per-function lint rules could never see).

Every ``.py`` file under the package is parsed once; every function,
method, nested function and lambda becomes a :class:`FuncDef` with a
stable qualified name (``relpath::Class.method``, ``relpath::func``,
``relpath::outer.inner``).  Call edges are resolved in decreasing order
of confidence:

1. **Lexical names** — local defs, enclosing-scope defs, module-level
   defs, and imports (``from ..utils import fs as fslib`` makes
   ``fslib.write_meta_json(...)`` resolve into ``utils/fs.py``).
2. **self/cls methods** — ``self.m()`` resolves within the enclosing
   class, then through project base classes.
3. **Receiver-type hints** — parameter annotations (``x: RingConfig``),
   local constructor assignments (``c = RPCClient(...)``), and
   ``self.attr = ClassName(...)`` bindings collected from ``__init__``
   (so ``self.insert.call(...)`` resolves through ``RPCClient``).
4. **Attribute-name fallback** — ``storage.search_series(...)`` links to
   every project class defining ``search_series`` when the name is
   distinctive (few definers, not in the ubiquitous-name stoplist).
   Duck-typed seams (the ``storage`` protocol) stay covered without
   annotations; ``.get``/``.close``-style names never explode the graph.

Concurrency edges are calls: ``threading.Thread(target=f)``,
``POOL.run([partial(f, x) for ...])`` and ``pool.submit(f)`` all add an
edge to ``f`` — work handed to a thread or the shared workpool still
runs on behalf of the submitting path, which is exactly what the
deadline-taint pass (VMT012) needs to see.

Every edge also carries its *context*:

- ``locks`` — the lock identities lexically held at the call site
  (``with self._lock:`` regions; identities resolve through the
  ``make_lock``/``make_rlock`` name registry, so ``self._lock`` in two
  modules guarding the same ``make_lock("storage.Storage._lock")``
  instance unify).  The lockset pass (VMT015) intersects these along
  call chains to infer which lock guards each field.
- ``caught`` — the exception-type keys of every enclosing
  ``try/except`` at the call site.  The errorflow pass (VMT016) stops
  propagating an escaping exception type at the first frame that
  catches it.

Alongside edges the builder now records per-def *field accesses*
(``self.attr`` and module-global mutable containers, read vs write,
with the lexically-held locks), *raise sites* (resolved exception-type
keys with their enclosing handlers) and the ``make_lock`` name
bindings + exception base-class map those passes resolve against.

Consumers: :mod:`devtools.deadline_taint` (serving-path blocking-call
reachability), :mod:`devtools.lockset` (VMT015 guarded-by inference),
:mod:`devtools.errorflow` (VMT016 exception-escape audit) and
:mod:`devtools.wireschema` (marshal/unmarshal helper resolution).
Build cost is one AST parse per file (~120 files, well under a
second) — cheap enough for every full lint run.

The port's copy of ``victoriametrics_tpu/devtools/callgraph.py``, whole.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re

from .lint import _SUPPRESS_RE, dotted_name, iter_py_files, normalize_path
from .rules_locks import lockish_name

#: attribute names too generic to resolve by name alone: linking every
#: ``.get()`` to every class with a ``get`` method would connect the
#: whole graph through dict-shaped noise
_GENERIC_ATTRS = {
    "get", "put", "items", "keys", "values", "append", "extend", "add",
    "pop", "remove", "clear", "copy", "update", "setdefault", "close",
    "read", "write", "flush", "seek", "tell", "join", "split", "strip",
    "encode", "decode", "sort", "sorted", "index", "count", "format",
    "result", "wait", "acquire", "release", "send", "recv", "sendall",
    "connect", "accept", "start", "stop", "run", "submit", "info",
    "debug", "warning", "error", "sum", "min", "max", "mean", "all",
    "any", "tobytes", "astype", "reshape", "item", "fire", "inc", "dec",
    "set", "name", "startswith", "endswith", "lower", "upper", "replace",
}

#: max distinct project definers for attribute-name fallback resolution;
#: past this the name is effectively generic and edges would be noise
_MAX_ATTR_CANDIDATES = 8

#: receiver methods that mutate their container in place — a call like
#: ``self._cache.pop(k)`` is a WRITE access to the ``_cache`` field
_MUTATORS = {
    "append", "extend", "insert", "remove", "discard", "clear", "pop",
    "popitem", "popleft", "appendleft", "update", "setdefault", "sort",
    "reverse", "add",
}

#: constructor names whose module-level result is shared mutable state
_GLOBAL_CTORS = {
    "dict", "list", "set", "OrderedDict", "defaultdict", "deque",
    "Counter", "WeakValueDictionary",
}

#: keyword-argument names that hand a callable over for deferred
#: invocation on some other thread of control (service-thread ticks,
#: completion hooks) — matched literally or by the on_* prefix
_CALLBACK_KW_RE = re.compile(r"^on_[a-z0-9_]+$|^(callback|cb|hook)$")

#: external (non-project) callables with a documented raise contract the
#: errorflow pass should see: wire/payload parsing that throws on bad
#: input.  Kept deliberately tiny — flagging every int()/float() guard
#: in the tree would drown the real boundary gaps.
EXT_RAISERS = {
    "json.loads": "ValueError",
    "json.load": "ValueError",
}


def _make_lock_name(call) -> str | None:
    """The registry name of a ``make_lock("...")``/``make_rlock("...")``
    construction, else None."""
    if not isinstance(call, ast.Call):
        return None
    dn = dotted_name(call.func)
    if dn and dn.rpartition(".")[2] in ("make_lock", "make_rlock") and \
            call.args and isinstance(call.args[0], ast.Constant) and \
            isinstance(call.args[0].value, str):
        return call.args[0].value
    return None


@dataclasses.dataclass
class FuncDef:
    qname: str                  # "relpath::Class.method" / "relpath::func"
    rel_path: str
    name: str                   # bare name ("method", "func", "<lambda>")
    cls: str | None             # enclosing class name, if any
    node: object                # ast.FunctionDef/AsyncFunctionDef/Lambda
    lineno: int


@dataclasses.dataclass(frozen=True)
class Edge:
    target: str                 # callee qname
    lineno: int
    #: "call" | "thread" | "submit" | "ref" | "cbref" — cbref marks a
    #: callable handed over via a callback-shaped keyword argument
    #: (``on_tick=...``): it runs later on whatever thread the receiver
    #: invokes it from, so lockset treats the target as its own root
    kind: str
    #: lock identities lexically held at the call site (VMT015);
    #: empty for thread/submit edges — the spawned work runs in its own
    #: context and does not inherit the spawner's critical section
    locks: tuple = ()
    #: exception-type keys of enclosing try/except handlers (VMT016)
    caught: tuple = ()


class CallGraph:
    def __init__(self):
        self.defs: dict[str, FuncDef] = {}
        #: attr/method name -> qnames of project defs with that name
        self.by_name: dict[str, list[str]] = {}
        self.edges: dict[str, list[Edge]] = {}
        #: class qname ("relpath::Class") -> list of base-class qnames
        self.bases: dict[str, list[str]] = {}
        #: class qname -> {method name -> qname}
        self.methods: dict[str, dict[str, str]] = {}
        #: (relpath, local dotted alias) -> target, for module aliases
        self._imports: dict[tuple[str, str], str] = {}
        #: "relpath::Class" -> {attr -> class qname} from __init__ hints
        self._attr_types: dict[str, dict[str, str]] = {}
        #: module rel_path -> {top-level def/class name -> qname}
        self._module_scope: dict[str, dict[str, str]] = {}
        #: rel_path -> module ast (for passes that re-walk, e.g. wireschema)
        self.module_trees: dict[str, object] = {}
        self.sources: dict[str, str] = {}
        #: qname -> [(field_id, "read"|"write", lineno, locks)] — accesses
        #: to self.* fields / module-global containers (VMT015)
        self.accesses: dict[str, list[tuple]] = {}
        #: qname -> [(type_key, lineno, caught)] raise sites (VMT016);
        #: type_key is a project class qname or a builtin exception name
        self.raises: dict[str, list[tuple]] = {}
        #: qname -> [(dotted, lineno, caught)] calls into EXT_RAISERS
        self.ext_calls: dict[str, list[tuple]] = {}
        #: ("relpath::Class", attr) / (relpath, var) -> make_lock name
        self.lock_names: dict[tuple[str, str], str] = {}
        #: class qname -> base names with builtins KEPT as bare names
        #: (g.bases drops non-project bases; exception-hierarchy walks
        #: need RuntimeError/ValueError/... to stay visible)
        self.exc_bases: dict[str, list[str]] = {}
        #: rel_path -> {module-level mutable-global name -> lineno}
        self.module_globals: dict[str, dict[str, int]] = {}

    # -- queries ----------------------------------------------------------

    def callees(self, qname: str) -> list[Edge]:
        return self.edges.get(qname, [])

    def lookup(self, rel_path: str, dotted: str) -> str | None:
        """Resolve a dotted name as seen from ``rel_path`` module scope
        (``Class.method``, ``func``, imported ``mod.func``)."""
        scope = self._module_scope.get(rel_path, {})
        head, _, rest = dotted.partition(".")
        q = scope.get(head)
        if q is None:
            # `from mod import Name` binding
            bound = self._imports.get((rel_path, head + "@from"))
            if bound is not None:
                tgt_rel, _, tgt_name = bound.partition("::")
                q = self._module_scope.get(tgt_rel, {}).get(tgt_name)
            if q is None:
                return self._resolve_import(rel_path, dotted)
        if not rest:
            return q
        # Class.method within this module
        m = self.methods.get(q, {})
        return m.get(rest)

    def class_method(self, cls_qname: str, method: str) -> str | None:
        """Resolve a method through the project class hierarchy."""
        seen = set()
        stack = [cls_qname]
        while stack:
            c = stack.pop()
            if c in seen:
                continue
            seen.add(c)
            got = self.methods.get(c, {}).get(method)
            if got is not None:
                return got
            stack.extend(self.bases.get(c, []))
        return None

    def reachable(self, entries, stop=frozenset()) -> set[str]:
        """Qnames reachable from ``entries`` without descending INTO any
        function in ``stop`` (the deadline-aware wrapper seams)."""
        seen: set[str] = set()
        stack = [q for q in entries if q in self.defs]
        while stack:
            q = stack.pop()
            if q in seen or q in stop:
                continue
            seen.add(q)
            for e in self.edges.get(q, ()):
                if e.target not in seen and e.target not in stop:
                    stack.append(e.target)
        return seen

    def _resolve_import(self, rel_path: str, dotted: str) -> str | None:
        """``alias.func`` where alias is an imported module."""
        head, _, rest = dotted.partition(".")
        target = self._imports.get((rel_path, head))
        if target is None or not rest:
            return None
        # target is a module rel_path; rest may be func or Class.method
        first, _, tail = rest.partition(".")
        scope = self._module_scope.get(target, {})
        q = scope.get(first)
        if q is None:
            return None
        if not tail:
            return q
        return self.methods.get(q, {}).get(tail)


# -- shared pass helpers -----------------------------------------------------

def source_suppressed(g: CallGraph, rel: str, lineno: int,
                      rule_id: str) -> bool:
    """True when the source line carries ``# vmt: disable=<rule_id>`` —
    the inline-suppression check shared by the whole-program passes."""
    src = g.sources.get(rel)
    if src is None:
        return False
    lines = src.splitlines()
    if not (1 <= lineno <= len(lines)):
        return False
    m = _SUPPRESS_RE.search(lines[lineno - 1])
    return bool(m) and rule_id in {
        s.strip().upper() for s in m.group(1).split(",")}


def lock_identity(g: CallGraph, rel: str, cls_q: str | None, expr,
                  local_locks: dict[str, str]) -> str | None:
    """Stable identity of a lock-looking ``with`` context expression.

    A lock constructed via ``make_lock("storage.Storage._lock")`` is
    identified by that registry name wherever it is held — the name is
    the cross-module identity.  Unregistered locks fall back to a
    lexical id (``relpath::Class.attr`` / ``relpath::var``), which still
    unifies accesses within one class/module."""
    dn = lockish_name(expr)
    if dn is None:
        return None
    head, _, rest = dn.partition(".")
    if head in ("self", "cls") and cls_q and rest:
        seen: set[str] = set()
        stack = [cls_q]
        while stack:  # inherited locks bind in a base's __init__
            c = stack.pop()
            if c in seen:
                continue
            seen.add(c)
            named = g.lock_names.get((c, rest))
            if named is not None:
                return named
            stack.extend(g.bases.get(c, []))
        return f"{cls_q}.{rest}"
    if not rest and dn in local_locks:
        return local_locks[dn]
    named = g.lock_names.get((rel, head if not rest else dn))
    return named or f"{rel}::{dn}"


# -- builder ----------------------------------------------------------------

def _module_rel(pkg_root: str, module: str, cur_rel: str,
                level: int) -> str | None:
    """Rel-path of an imported module inside the package, else None."""
    if level:  # relative import: anchor at the current module's package
        base = cur_rel.rsplit("/", 1)[0]
        for _ in range(level - 1):
            base = base.rsplit("/", 1)[0] if "/" in base else ""
        parts = ([base] if base else []) + \
            ([p for p in module.split(".")] if module else [])
        dotted = "/".join(p for p in parts if p)
    else:
        dotted = module.replace(".", "/") if module else ""
    if not dotted:
        return None
    for cand in (dotted + ".py", dotted + "/__init__.py"):
        if os.path.exists(os.path.join(pkg_root, cand)):
            return cand
    return None


class _ModuleIndexer(ast.NodeVisitor):
    """Pass 1: defs, classes, imports, __init__ attr-type hints."""

    def __init__(self, g: CallGraph, rel: str, repo_root: str):
        self.g = g
        self.rel = rel
        self.repo_root = repo_root
        self.scope: list[str] = []       # qname parts under the module
        self.cls_stack: list[str] = []   # class qnames

    def _q(self, name: str) -> str:
        return f"{self.rel}::" + ".".join(self.scope + [name])

    def _add_def(self, node, name: str):
        q = self._q(name)
        cls = self.cls_stack[-1].split("::")[-1] if self.cls_stack else None
        fd = FuncDef(q, self.rel, name, cls, node, node.lineno)
        self.g.defs[q] = fd
        self.g.by_name.setdefault(name, []).append(q)
        if self.cls_stack and len(self.scope) == 1:
            self.g.methods.setdefault(self.cls_stack[-1], {})[name] = q
        if not self.scope:
            self.g._module_scope.setdefault(self.rel, {})[name] = q
        return q

    def visit_FunctionDef(self, node):
        self._add_def(node, node.name)
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        self._add_def(node, f"<lambda@{node.lineno}>")
        self.generic_visit(node)

    def visit_ClassDef(self, node):
        q = f"{self.rel}::{node.name}"
        if not self.scope:
            self.g._module_scope.setdefault(self.rel, {})[node.name] = q
            self.g.by_name.setdefault(node.name, []).append(q)
        self.g.methods.setdefault(q, {})
        self.cls_stack.append(q)
        self.scope.append(node.name)
        # base names resolved in pass 2 (they may be imports)
        self.g.bases.setdefault(q, [])
        for b in node.bases:
            dn = dotted_name(b)
            if dn:
                self.g.bases[q].append(f"?{self.rel}?{dn}")
        self.generic_visit(node)
        self.scope.pop()
        self.cls_stack.pop()

    def visit_Import(self, node):
        for alias in node.names:
            tgt = _module_rel(self.repo_root, alias.name, self.rel, 0)
            if tgt:
                local = alias.asname or alias.name.split(".")[0]
                self.g._imports[(self.rel, local)] = tgt

    def visit_ImportFrom(self, node):
        mod_rel = _module_rel(self.repo_root, node.module or "", self.rel,
                              node.level)
        if mod_rel is None:
            return
        for alias in node.names:
            local = alias.asname or alias.name
            # imported def/class: alias directly into module scope later
            # (pass 2 may need it before the target module is indexed,
            # so record as a deferred import binding)
            sub = _module_rel(self.repo_root, (node.module or "") + "." +
                              alias.name, self.rel, node.level)
            if sub is not None:   # `from ..pkg import module`
                self.g._imports[(self.rel, local)] = sub
            else:                 # `from ..pkg.module import name`
                self.g._imports[(self.rel, local + "@from")] = \
                    mod_rel + "::" + alias.name


class _EdgeBuilder:
    """Pass 2: call edges for every def."""

    def __init__(self, g: CallGraph, rel: str):
        self.g = g
        self.rel = rel

    def _resolve_name(self, name: str, scope_defs: list[dict]) -> str | None:
        for frame in reversed(scope_defs):
            if name in frame:
                return frame[name]
        q = self.g._module_scope.get(self.rel, {}).get(name)
        if q is not None:
            return q
        # `from mod import name` binding
        bound = self.g._imports.get((self.rel, name + "@from"))
        if bound is not None:
            tgt_rel, _, tgt_name = bound.partition("::")
            return self.g._module_scope.get(tgt_rel, {}).get(tgt_name)
        return None

    def _resolve_dotted(self, dn: str, scope_defs, cls_q, types) -> \
            list[str]:
        """Candidate qnames for a dotted callee name."""
        head, _, rest = dn.partition(".")
        if not rest:
            q = self._resolve_name(dn, scope_defs)
            return [q] if q else []
        if head in ("self", "cls") and cls_q:
            if "." not in rest:
                q = self.g.class_method(cls_q, rest)
                if q:
                    return [q]
            else:  # self.attr.method(): __init__ type hints
                attr, _, meth = rest.partition(".")
                t = self.g._attr_types.get(cls_q, {}).get(attr)
                if t and "." not in meth:
                    q = self.g.class_method(t, meth)
                    if q:
                        return [q]
                return self._by_attr_name(meth.rpartition(".")[2])
            return self._by_attr_name(rest)
        # typed local receiver
        t = types.get(head)
        if t is not None and "." not in rest:
            q = self.g.class_method(t, rest)
            if q:
                return [q]
        # imported module alias / module-scope class
        q = self.g.lookup(self.rel, dn)
        if q is not None:
            return [q]
        return self._by_attr_name(rest.rpartition(".")[2])

    def _by_attr_name(self, name: str) -> list[str]:
        if not name or name in _GENERIC_ATTRS:
            return []
        cands = [q for q in self.g.by_name.get(name, ())
                 if self.g.defs.get(q) and self.g.defs[q].cls]
        if 0 < len(cands) <= _MAX_ATTR_CANDIDATES:
            return cands
        return []

    def _callable_refs(self, node) -> list[object]:
        """Callable-reference expressions inside a submit/run argument:
        bare names, ``partial(f, ...)``, list/comprehension elements."""
        out = []
        if isinstance(node, (ast.Name, ast.Attribute, ast.Lambda)):
            out.append(node)
        elif isinstance(node, ast.Call):
            dn = dotted_name(node.func)
            if dn and dn.rpartition(".")[2] == "partial" and node.args:
                out.extend(self._callable_refs(node.args[0]))
        elif isinstance(node, (ast.List, ast.Tuple, ast.Set)):
            for e in node.elts:
                out.extend(self._callable_refs(e))
        elif isinstance(node, (ast.ListComp, ast.GeneratorExp,
                               ast.SetComp)):
            out.extend(self._callable_refs(node.elt))
        elif isinstance(node, ast.Starred):
            out.extend(self._callable_refs(node.value))
        return out

    def _lambda_q(self, lineno: int) -> str | None:
        suffix = f"<lambda@{lineno}>"
        for q in self.g.defs:
            if q.startswith(self.rel + "::") and q.endswith(suffix):
                return q
        return None

    def _ref_qnames(self, ref, scope_defs, cls_q, types) -> list[str]:
        if isinstance(ref, ast.Lambda):
            q = self._lambda_q(ref.lineno)
            return [q] if q else []
        rdn = dotted_name(ref)
        if not rdn:
            return []
        return self._resolve_dotted(rdn, scope_defs, cls_q, types)

    def build(self, fd: FuncDef, scope_defs: list[dict], cls_q,
              types: dict):
        edges = self.g.edges.setdefault(fd.qname, [])
        accesses = self.g.accesses.setdefault(fd.qname, [])
        raise_sites = self.g.raises.setdefault(fd.qname, [])
        ext_calls = self.g.ext_calls.setdefault(fd.qname, [])
        seen = set()
        local_locks: dict[str, str] = {}
        skip_reads: set[int] = set()    # node ids already counted

        node0 = fd.node
        body = [node0.body] if isinstance(node0, ast.Lambda) \
            else list(node0.body)

        # names the function binds locally: a bare Name only refers to a
        # module global when the function neither assigns it nor takes
        # it as a parameter (or re-exports it via `global`)
        local_names: set[str] = set()
        global_names: set[str] = set()
        a = node0.args
        for arg in (list(a.args) + list(a.posonlyargs) +
                    list(a.kwonlyargs) +
                    ([a.vararg] if a.vararg else []) +
                    ([a.kwarg] if a.kwarg else [])):
            local_names.add(arg.arg)
        stack = list(body)
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                local_names.add(n.name)
                continue
            if isinstance(n, ast.Lambda):
                continue
            if isinstance(n, ast.Global):
                global_names.update(n.names)
            elif isinstance(n, ast.Name) and \
                    isinstance(n.ctx, (ast.Store, ast.Del)):
                local_names.add(n.id)
            stack.extend(ast.iter_child_nodes(n))
        local_names -= global_names
        mod_globals = self.g.module_globals.get(self.rel, {})

        def add(q: str | None, lineno: int, kind: str,
                locks: tuple = (), caught: tuple = ()):
            key = (q, kind, locks, caught)
            if q and q != fd.qname and key not in seen:
                seen.add(key)
                edges.append(Edge(q, lineno, kind, locks, caught))

        def field_of(expr):
            """Field id for a self-attribute / module-global access,
            else None.  Subscript chains unwrap to their base
            (``self._cache[k]`` accesses ``_cache``)."""
            while isinstance(expr, ast.Subscript):
                expr = expr.value
            if isinstance(expr, ast.Attribute) and \
                    isinstance(expr.value, ast.Name) and \
                    expr.value.id in ("self", "cls") and cls_q:
                if lockish_name(expr) or \
                        self.g.class_method(cls_q, expr.attr) is not None:
                    return None   # the lock itself / a bound method
                return f"{cls_q}.{expr.attr}"
            if isinstance(expr, ast.Name) and expr.id in mod_globals and \
                    expr.id not in local_names and \
                    lockish_name(expr) is None:
                return f"{self.rel}::{expr.id}"
            return None

        def exc_keys(tnode) -> tuple:
            """Type keys of an except clause: project class qnames when
            resolvable, bare builtin names otherwise; "*" for bare
            except / Exception / BaseException."""
            if tnode is None:
                return ("*",)
            elts = tnode.elts if isinstance(tnode, ast.Tuple) else [tnode]
            keys = []
            for t in elts:
                dn = dotted_name(t)
                if not dn:
                    continue
                last = dn.rpartition(".")[2]
                if last in ("Exception", "BaseException"):
                    keys.append("*")
                    continue
                q = self.g.lookup(self.rel, dn)
                if q is None and "." not in dn:
                    q = self._resolve_name(dn, scope_defs)
                keys.append(q if q in self.g.methods else last)
            return tuple(keys) or ("*",)

        def record_raise(node, caught, hvars, htypes):
            if node.exc is None:       # bare re-raise inside a handler
                for k in htypes:
                    if k != "*":
                        raise_sites.append((k, node.lineno, caught))
                return
            e = node.exc
            target = e.func if isinstance(e, ast.Call) else e
            dn = dotted_name(target)
            if not dn:
                return
            if dn in hvars:            # `raise e` of the caught exc
                for k in hvars[dn]:
                    if k != "*":
                        raise_sites.append((k, node.lineno, caught))
                return
            q = self.g.lookup(self.rel, dn)
            if q is None and "." not in dn:
                q = self._resolve_name(dn, scope_defs)
            key = q if q in self.g.methods else dn.rpartition(".")[2]
            raise_sites.append((key, node.lineno, caught))

        def visit(node, locks, caught, hvars, htypes):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                return   # nested defs get their own edge sets
            if isinstance(node, ast.Try):
                handler_keys = tuple(k for h in node.handlers
                                     for k in exc_keys(h.type))
                # `try: ... finally: X.release()` brackets a lock region
                # even when the acquire is out of line (a conditional
                # try-acquire, or a helper returning with the lock HELD,
                # e.g. Storage._acquire_cspace) — the body runs under X
                body_locks = locks
                for n in node.finalbody:
                    if isinstance(n, ast.Expr) \
                            and isinstance(n.value, ast.Call) \
                            and isinstance(n.value.func, ast.Attribute) \
                            and n.value.func.attr == "release" \
                            and lockish_name(n.value.func.value):
                        lid = lock_identity(self.g, self.rel, cls_q,
                                            n.value.func.value, local_locks)
                        if lid and lid not in body_locks:
                            body_locks = body_locks + (lid,)
                for n in node.body:
                    visit(n, body_locks, caught + handler_keys, hvars,
                          htypes)
                for h in node.handlers:
                    keys = exc_keys(h.type)
                    hv = dict(hvars)
                    if h.name:
                        hv[h.name] = keys
                    for n in h.body:   # handler body: outer tries only
                        visit(n, locks, caught, hv, keys)
                for n in node.orelse:  # else runs before finally: held
                    visit(n, body_locks, caught, hvars, htypes)
                for n in node.finalbody:
                    visit(n, locks, caught, hvars, htypes)
                return
            if isinstance(node, (ast.With, ast.AsyncWith)):
                new_locks = locks
                for item in node.items:
                    visit(item.context_expr, locks, caught, hvars, htypes)
                    lid = lock_identity(self.g, self.rel, cls_q,
                                        item.context_expr, local_locks)
                    if lid and lid not in new_locks:
                        new_locks = new_locks + (lid,)
                for n in node.body:
                    visit(n, new_locks, caught, hvars, htypes)
                return
            if isinstance(node, ast.Raise):
                record_raise(node, caught, hvars, htypes)
            # local lock construction + constructor type hints
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call):
                lname = _make_lock_name(node.value)
                dn = dotted_name(node.value.func)
                tq = None
                if dn:
                    tq = self.g.lookup(self.rel, dn) or \
                        self._resolve_name(dn, scope_defs)
                for t in node.targets:
                    if not isinstance(t, ast.Name):
                        continue
                    if lname:
                        local_locks[t.id] = lname
                    if tq in self.g.methods:  # it's a class
                        types[t.id] = tq
            if isinstance(node, ast.Call):
                dn = dotted_name(node.func)
                if dn:
                    last = dn.rpartition(".")[2]
                    if last == "Thread":
                        for kw in node.keywords:
                            if kw.arg == "target":
                                for ref in self._callable_refs(kw.value):
                                    for q in self._ref_qnames(
                                            ref, scope_defs, cls_q, types):
                                        add(q, node.lineno, "thread")
                    elif last in ("submit", "run") and \
                            isinstance(node.func, ast.Attribute):
                        for arg in list(node.args):
                            for ref in self._callable_refs(arg):
                                for q in self._ref_qnames(
                                        ref, scope_defs, cls_q, types):
                                    add(q, node.lineno, "submit")
                    # callback-shaped keyword: the callable escapes into
                    # the receiver and runs on ITS thread later
                    for kw in node.keywords:
                        if kw.arg and _CALLBACK_KW_RE.match(kw.arg):
                            for ref in self._callable_refs(kw.value):
                                for q in self._ref_qnames(
                                        ref, scope_defs, cls_q, types):
                                    add(q, node.lineno, "cbref")
                    resolved = self._resolve_dotted(dn, scope_defs, cls_q,
                                                    types)
                    for q in resolved:
                        # constructor call -> edge to __init__
                        if q in self.g.methods:
                            q = self.g.methods[q].get("__init__")
                        add(q, node.lineno, "call", locks, caught)
                    if not resolved and dn in EXT_RAISERS:
                        ext_calls.append((dn, node.lineno, caught))
                elif isinstance(node.func, ast.Attribute):
                    # method call on a computed receiver — e.g.
                    # ``api.init_sloplane().maybe_eval(...)`` — falls
                    # back to distinctive-attribute-name resolution
                    for q in self._by_attr_name(node.func.attr):
                        add(q, node.lineno, "call", locks, caught)
                # callback handoff: a bare function name passed as an
                # argument (``self._fan_stripes(by_shard, do_register)``)
                # still runs on behalf of this caller — lexical
                # resolution only, so dict/str arguments add no noise
                for arg in list(node.args) + \
                        [kw.value for kw in node.keywords]:
                    if isinstance(arg, ast.Name):
                        q = self._resolve_name(arg.id, scope_defs)
                        if q is not None and q in self.g.defs:
                            add(q, node.lineno, "ref", locks, caught)
                # in-place mutation through a container method is a
                # write to the container field
                f = node.func
                if isinstance(f, ast.Attribute) and f.attr in _MUTATORS:
                    base = f.value
                    fld = field_of(base)
                    if fld:
                        accesses.append((fld, "write", node.lineno, locks))
                        while isinstance(base, ast.Subscript):
                            base = base.value
                        skip_reads.add(id(base))
            # field reads/writes: ctx tells stores from loads
            if isinstance(node, (ast.Attribute, ast.Name, ast.Subscript)):
                ctx = getattr(node, "ctx", None)
                if isinstance(ctx, (ast.Store, ast.Del)):
                    fld = field_of(node)
                    if fld is None and isinstance(node, ast.Attribute):
                        # `self.stats.hits = 3` mutates what `stats`
                        # refers to — a write to the outer field
                        fld = field_of(node.value)
                        if fld:
                            skip_reads.add(id(node.value))
                    if fld:
                        accesses.append((fld, "write", node.lineno, locks))
                    base = node
                    while isinstance(base, ast.Subscript):
                        base = base.value       # self._c[k] = v: the
                        skip_reads.add(id(base))  # Load of _c is the write
                elif isinstance(ctx, ast.Load) and \
                        not isinstance(node, ast.Subscript) and \
                        id(node) not in skip_reads:
                    fld = field_of(node)
                    if fld:
                        accesses.append((fld, "read", node.lineno, locks))
            for child in ast.iter_child_nodes(node):
                visit(child, locks, caught, hvars, htypes)

        for n in body:
            visit(n, (), (), {}, ())


def _annotation_types(g: CallGraph, rel: str, node) -> dict[str, str]:
    """Param-annotation receiver types (``x: RingConfig``)."""
    types: dict[str, str] = {}
    if isinstance(node, ast.Lambda):
        return types
    args = node.args
    for a in list(args.args) + list(args.posonlyargs) + \
            list(args.kwonlyargs):
        if a.annotation is not None:
            dn = dotted_name(a.annotation)
            if dn is None and isinstance(a.annotation, ast.Constant) and \
                    isinstance(a.annotation.value, str):
                dn = a.annotation.value.strip("'\" ").split("|")[0].strip()
            if dn:
                q = g.lookup(rel, dn)
                if q in g.methods:
                    types[a.arg] = q
    return types


def _collect_attr_types(g: CallGraph):
    """``self.attr = ClassName(...)`` hints from every method (the
    ``__init__``-heavy case plus lazy constructions elsewhere)."""
    for cls_q, methods in g.methods.items():
        hints = g._attr_types.setdefault(cls_q, {})
        for mq in methods.values():
            fd = g.defs.get(mq)
            if fd is None or isinstance(fd.node, ast.Lambda):
                continue
            for node in ast.walk(fd.node):
                if not (isinstance(node, ast.Assign) and
                        isinstance(node.value, ast.Call)):
                    continue
                dn = dotted_name(node.value.func)
                if not dn:
                    continue
                tq = g.lookup(fd.rel_path, dn)
                if tq not in g.methods:
                    continue
                for t in node.targets:
                    if isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id == "self":
                        hints.setdefault(t.attr, tq)


def _resolve_bases(g: CallGraph):
    for cls_q, bases in g.bases.items():
        out, raw = [], []
        for b in bases:
            if b.startswith("?"):
                _, rel, dn = b.split("?", 2)
                q = g.lookup(rel, dn)
                if q in g.methods:
                    out.append(q)
                    raw.append(q)
                else:   # builtin/stdlib base: keep the bare name for
                    raw.append(dn.rpartition(".")[2])  # hierarchy walks
            elif b in g.methods:
                out.append(b)
                raw.append(b)
        g.bases[cls_q] = out
        g.exc_bases[cls_q] = raw


def _mutable_global_value(val) -> bool:
    if isinstance(val, (ast.Dict, ast.List, ast.Set, ast.DictComp,
                        ast.ListComp, ast.SetComp, ast.Constant)):
        return True
    if isinstance(val, ast.Call):
        dn = dotted_name(val.func)
        return bool(dn) and dn.rpartition(".")[2] in _GLOBAL_CTORS
    return False


def _index_module_level(g: CallGraph, rel: str, tree):
    """Module-level ``make_lock`` bindings and mutable globals (shared
    state a function can reach without going through ``self``).  Scalar
    constants are included too: ``_N = 0`` rebound via ``global _N`` is
    just as much shared state as a dict."""
    globs = g.module_globals.setdefault(rel, {})
    for node in tree.body:
        if isinstance(node, ast.Assign):
            tgts, val = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            tgts, val = [node.target], node.value
        else:
            continue
        lname = _make_lock_name(val)
        for t in tgts:
            if not isinstance(t, ast.Name):
                continue
            if lname:
                g.lock_names.setdefault((rel, t.id), lname)
            elif _mutable_global_value(val):
                globs.setdefault(t.id, node.lineno)


def _collect_lock_names(g: CallGraph):
    """``self.attr = make_lock("name")`` bindings from every method —
    the registry name is the lock's cross-module identity."""
    for fd in g.defs.values():
        if isinstance(fd.node, ast.Lambda) or fd.cls is None:
            continue
        cls_q = f"{fd.rel_path}::{fd.cls}"
        for node in ast.walk(fd.node):
            if not isinstance(node, ast.Assign):
                continue
            lname = _make_lock_name(node.value)
            if not lname:
                continue
            for t in node.targets:
                if isinstance(t, ast.Attribute) and \
                        isinstance(t.value, ast.Name) and \
                        t.value.id == "self":
                    g.lock_names.setdefault((cls_q, t.attr), lname)


def build_callgraph(paths, repo_root: str | None = None) -> CallGraph:
    """Build the graph over every ``.py`` file under ``paths``."""
    from .lint import REPO_ROOT
    repo_root = repo_root or REPO_ROOT
    g = CallGraph()
    trees: list[tuple[str, object]] = []
    for path in iter_py_files(paths):
        rel = normalize_path(path)
        try:
            with open(path, encoding="utf-8") as fh:
                src = fh.read()
            tree = ast.parse(src, filename=path)
        except (OSError, SyntaxError):
            continue
        g.sources[rel] = src
        g.module_trees[rel] = tree
        trees.append((rel, tree))
        _ModuleIndexer(g, rel, repo_root).visit(tree)
    _resolve_bases(g)
    _collect_attr_types(g)
    _collect_lock_names(g)
    for rel, tree in trees:
        _index_module_level(g, rel, tree)
    for rel, tree in trees:
        eb = _EdgeBuilder(g, rel)

        # walk defs with their lexical scope chains; `scope_names` is the
        # dotted path OF `node` (empty for the module), so a def is built
        # against frames that include its OWN nested defs — h_search can
        # call its local `frames()` helper and POOL.run list-comps over
        # nested workers resolve
        def walk(node, scope_defs, scope_names, cls_q):
            local: dict[str, str] = {}
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    local[child.name] = f"{rel}::" + ".".join(
                        scope_names + [child.name])
            frames = scope_defs + [local]
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fd = g.defs.get(f"{rel}::" + ".".join(scope_names))
                if fd is not None:
                    eb.build(fd, frames, cls_q,
                             _annotation_types(g, rel, node))
            elif isinstance(node, ast.Lambda):
                fd = g.defs.get(f"{rel}::" + ".".join(scope_names))
                if fd is not None:
                    eb.build(fd, frames, cls_q, {})
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    walk(child, frames, scope_names + [child.name], cls_q)
                elif isinstance(child, ast.ClassDef):
                    walk(child, frames, scope_names + [child.name],
                         f"{rel}::{child.name}")
                elif isinstance(child, ast.Lambda):
                    walk(child, frames,
                         scope_names + [f"<lambda@{child.lineno}>"],
                         cls_q)
                else:
                    walk(child, frames, scope_names, cls_q)
        walk(tree, [], [], None)
    return g
