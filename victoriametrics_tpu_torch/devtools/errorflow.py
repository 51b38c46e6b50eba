"""VMT016 — exception-escape audit over the whole-program call graph.

The serving boundaries translate *typed* failures into *typed* wire
responses: the HTTP boundary (``httpapi/server.py::_handle``) maps
``RateLimitedError``/``SearchLimitError`` to 429 + Retry-After, the RPC
boundary (``parallel/rpc.py::_dispatch``) maps ``DeadlineExceededError``
and ``SearchLimitError`` to typed ``\\x01`` wire markers.  Everything
else falls into the anonymous ``except Exception`` arm: HTTP 500
"internal", or an unmarked RPC error frame that the client can only
re-raise as a generic ``RPCError``.

That anonymous arm is the bug this pass hunts: a *project-defined*
exception type (or a documented external raiser like ``json.loads``)
that can propagate from a serving entry point all the way to the
boundary without a typed mapping.  A ``ClusterUnavailableError`` that
surfaces as a bare 500 loses the one bit the caller needs (retry me —
this is capacity, not a bug); a ``PartialResultError`` that becomes an
anonymous error frame can no longer be degraded gracefully.

Mechanics:

- **Boundary mapped sets are scanned, not hardcoded**: the top-level
  ``except`` clauses of ``_handle`` and ``_dispatch`` are read from the
  AST, so adding a mapping at the boundary immediately retires the
  finding.  The wildcard ``except Exception`` arm contributes nothing —
  it IS the anonymous path.
- **Escape sets by fixpoint**: each function's set of statically
  raisable exception type keys is seeded from its own ``raise`` sites
  (minus types already caught by an enclosing ``try`` at the raise
  site) plus calls into :data:`callgraph.EXT_RAISERS`, then propagated
  caller-ward along ``call`` edges, filtering each hop by the ``except``
  clauses lexically enclosing the call site.  Catching is
  hierarchy-aware: ``except RPCError`` covers
  ``ClusterUnavailableError`` via ``exc_bases``, and builtin ancestry
  (``KeyError`` < ``LookupError`` < ``Exception``) is baked in.
- **Flag policy**: only project-qname types and EXT_RAISERS-origin
  builtins are reported.  Flagging every bare ``ValueError`` a
  validator raises would drown the boundary-contract signal; those
  raises are *meant* to be 4xx-ed by the handler layer, and when they
  are not, the project-typed wrappers (``QueryError``, ``ParseError``)
  are the ones this pass sees.

Findings anchor at the origin ``raise`` site (that is where the typed
mapping decision belongs — map it at the boundary, catch it en route,
or re-raise as an already-mapped type) and carry the witness chain
entry -> ... -> origin.  ``# vmt: disable=VMT016`` on the raise line is
honored for sanctioned escapes, with consumed suppressions reported so
VMT013 can flag stale ones.

The port's copy of ``victoriametrics_tpu/devtools/errorflow.py``, whole.
"""

from __future__ import annotations

import argparse
import ast
import os
import sys

from .callgraph import (CallGraph, EXT_RAISERS, build_callgraph,
                        dotted_name, source_suppressed)
from .deadline_taint import find_entries
from .lint import Finding

RULE_ID = "VMT016"

#: (boundary kind, module rel_path, function name) — the error
#: boundaries whose top-level ``except`` clauses define the typed
#: mapping sets.  The wildcard arm is the anonymous path, not a mapping.
BOUNDARIES = (
    ("http", "victoriametrics_tpu_torch/httpapi/server.py", "_handle"),
    ("rpc", "victoriametrics_tpu_torch/parallel/rpc.py", "_dispatch"),
)

#: builtin exception ancestry (child -> parent), enough to make
#: ``except LookupError`` cover a ``KeyError`` and friends.  Project
#: classes use ``g.exc_bases``; the two tables chain (a project class
#: deriving ``RuntimeError`` walks into this one).
_BUILTIN_BASES = {
    "ValueError": "Exception",
    "UnicodeError": "ValueError",
    "UnicodeDecodeError": "UnicodeError",
    "UnicodeEncodeError": "UnicodeError",
    "KeyError": "LookupError",
    "IndexError": "LookupError",
    "LookupError": "Exception",
    "RuntimeError": "Exception",
    "NotImplementedError": "RuntimeError",
    "RecursionError": "RuntimeError",
    "ArithmeticError": "Exception",
    "ZeroDivisionError": "ArithmeticError",
    "OverflowError": "ArithmeticError",
    "OSError": "Exception",
    "IOError": "OSError",
    "ConnectionError": "OSError",
    "ConnectionResetError": "ConnectionError",
    "ConnectionAbortedError": "ConnectionError",
    "ConnectionRefusedError": "ConnectionError",
    "BrokenPipeError": "ConnectionError",
    "TimeoutError": "OSError",
    "FileNotFoundError": "OSError",
    "FileExistsError": "OSError",
    "PermissionError": "OSError",
    "IsADirectoryError": "OSError",
    "NotADirectoryError": "OSError",
    "InterruptedError": "OSError",
    "HTTPError": "OSError",          # urllib.error: URLError < OSError
    "URLError": "OSError",
    "AttributeError": "Exception",
    "TypeError": "Exception",
    "NameError": "Exception",
    "StopIteration": "Exception",
    "MemoryError": "Exception",
    "EOFError": "Exception",
    "AssertionError": "Exception",
    "ResourceWarning": "Exception",  # Warning < Exception
}


def catches(g: CallGraph, key: str, handler_keys) -> bool:
    """Would an ``except`` clause with ``handler_keys`` catch an
    exception of type ``key``?  Walks the ancestry — project bases via
    ``g.exc_bases`` (builtin bases stay visible there as bare names),
    builtin bases via :data:`_BUILTIN_BASES`."""
    if not handler_keys:
        return False
    if "*" in handler_keys:
        return True
    seen = set()
    stack = [key]
    while stack:
        c = stack.pop()
        if c in seen:
            continue
        seen.add(c)
        if c in handler_keys:
            return True
        if "::" in c:
            stack.extend(g.exc_bases.get(c, ()))
        elif c in _BUILTIN_BASES:
            stack.append(_BUILTIN_BASES[c])
    return False


# -- boundary mapped sets ---------------------------------------------------

def boundary_mappings(g: CallGraph) -> dict[str, dict]:
    """kind -> {"rel": .., "line": .., "mapped": frozenset(type keys)}
    scanned from the boundary functions' top-level ``except`` clauses.
    Only typed (non-wildcard) handlers count as mappings."""
    out: dict[str, dict] = {}
    for kind, rel, fname in BOUNDARIES:
        tree = g.module_trees.get(rel)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.FunctionDef) or node.name != fname:
                continue
            mapped: set[str] = set()
            for stmt in node.body:        # top-level tries only: the
                if not isinstance(stmt, ast.Try):   # nested cleanup
                    continue                        # tries are not the
                for h in stmt.handlers:             # boundary contract
                    tnode = h.type
                    if tnode is None:
                        continue
                    elts = tnode.elts if isinstance(tnode, ast.Tuple) \
                        else [tnode]
                    for t in elts:
                        dn = dotted_name(t)
                        if not dn:
                            continue
                        last = dn.rpartition(".")[2]
                        if last in ("Exception", "BaseException"):
                            continue   # the anonymous arm
                        q = g.lookup(rel, dn)
                        mapped.add(q if q in g.methods else last)
            out[kind] = {"rel": rel, "line": node.lineno, "fn": fname,
                         "mapped": frozenset(mapped)}
            break
    return out


# -- escape-set fixpoint ----------------------------------------------------

def escape_sets(g: CallGraph):
    """``esc[q]`` maps each exception type key that can propagate out of
    ``q`` to its origin ``(rel, line, origin_q, src)`` — the raise site
    (``src`` names the external raiser for EXT_RAISERS seeds, else
    ``"raise"``).  ``hop[(q, key)]`` is the callee the key arrived
    from (None when raised in ``q`` itself), for witness chains."""
    esc: dict[str, dict[str, tuple]] = {}
    hop: dict[tuple[str, str], str | None] = {}

    def seed(q, key, rel, line, src):
        if key not in esc.setdefault(q, {}):
            esc[q][key] = (rel, line, q, src)
            hop[(q, key)] = None

    for q, sites in g.raises.items():
        rel = q.partition("::")[0]
        for (key, line, caught) in sites:
            if key == "*" or catches(g, key, caught):
                continue
            seed(q, key, rel, line, "raise")
    for q, calls in g.ext_calls.items():
        rel = q.partition("::")[0]
        for (dotted, line, caught) in calls:
            key = EXT_RAISERS[dotted]
            if not catches(g, key, caught):
                seed(q, key, rel, line, f"{dotted}()")

    callers: dict[str, list[tuple]] = {}
    for q, edges in g.edges.items():
        for e in edges:
            if e.kind == "call" and e.target in g.defs:
                callers.setdefault(e.target, []).append((q, e.caught))

    work = list(esc)
    while work:
        callee = work.pop()
        ev = esc.get(callee)
        if not ev:
            continue
        for (caller, caught) in callers.get(callee, ()):
            grew = False
            for key, origin in ev.items():
                if catches(g, key, caught):
                    continue
                if key not in esc.setdefault(caller, {}):
                    esc[caller][key] = origin
                    hop[(caller, key)] = callee
                    grew = True
            if grew:
                work.append(caller)
    return esc, hop


def _chain(g: CallGraph, hop: dict, q: str, key: str) -> str:
    names = []
    cur: str | None = q
    while cur is not None:
        names.append(g.defs[cur].name if cur in g.defs else cur)
        cur = hop.get((cur, key))
    if len(names) > 5:
        names = names[:2] + ["..."] + names[-2:]
    return " -> ".join(names)


def _short(key: str) -> str:
    return key.rpartition("::")[2]


# -- the pass ---------------------------------------------------------------

def serving_entries(g: CallGraph) -> dict[str, str]:
    """The deadline-taint entries that sit behind an error boundary
    (matstream advance has no wire response to type)."""
    return {q: why for q, why in find_entries(g).items()
            if why.startswith(("http ", "rpc "))}


def run_pass(g: CallGraph | None = None, paths=None):
    """Returns (findings, used_suppressions); the latter is
    ``{rel_path: {(line, RULE_ID), ...}}`` for VMT013's bookkeeping."""
    if g is None:
        g = build_callgraph(paths or _default_paths())
    bounds = boundary_mappings(g)
    esc, hop = escape_sets(g)
    entries = serving_entries(g)

    # every raise site of (function, type): a disable on ANY of them
    # suppresses the finding (mirrors lockset's any-access-site rule —
    # which same-typed raise becomes the reported origin is a seeding
    # detail the suppression must not depend on)
    raise_sites: dict[tuple, list[tuple]] = {}
    for oq, sites in g.raises.items():
        rel = oq.partition("::")[0]
        for (key, line, _caught) in sites:
            raise_sites.setdefault((oq, key), []).append((rel, line))
    for oq, calls in g.ext_calls.items():
        rel = oq.partition("::")[0]
        for (dotted, line, _caught) in calls:
            raise_sites.setdefault((oq, EXT_RAISERS[dotted]),
                                   []).append((rel, line))

    findings: list[Finding] = []
    used: dict[str, set] = {}
    reported: set[tuple] = set()
    for q in sorted(entries, key=lambda q: entries[q]):
        why = entries[q]
        kind = why.split(None, 1)[0]
        b = bounds.get(kind)
        if b is None:
            continue
        for key, (rel, line, origin_q, src) in sorted(
                (esc.get(q) or {}).items()):
            if "::" not in key and src == "raise":
                continue   # bare builtin from project code: handler-
                           # layer 4xx territory, not a boundary gap
            if catches(g, key, b["mapped"]):
                continue
            site = (kind, key, rel, line)
            if site in reported:
                continue
            reported.add(site)
            sup = [(srel, sline) for srel, sline in
                   raise_sites.get((origin_q, key), [(rel, line)])
                   if source_suppressed(g, srel, sline, RULE_ID)]
            if sup:
                for srel, sline in sup:
                    used.setdefault(srel, set()).add((sline, RULE_ID))
                continue
            via = f" via {src}" if src != "raise" else ""
            findings.append(Finding(
                rel, line, RULE_ID,
                f"{_short(key)} raised here{via} escapes to the {kind} "
                f"boundary ({b['rel']}::{b['fn']}) as an anonymous "
                f"{'500' if kind == 'http' else 'error frame'} from "
                f"[{why}] via {_chain(g, hop, q, key)} — map it at the "
                f"boundary, catch it en route, or re-raise as a mapped "
                f"type"))
    findings.sort(key=lambda f: (f.path, f.line))
    return findings, used


def _default_paths():
    from .lint import REPO_ROOT
    return [os.path.join(REPO_ROOT, "victoriametrics_tpu_torch")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m victoriametrics_tpu_torch.devtools.errorflow",
        description="VMT016: project exception types reaching the "
                    "HTTP/RPC error boundary without a typed-status "
                    "mapping (static exception-escape audit).")
    ap.add_argument("paths", nargs="*")
    ap.add_argument("--list-boundaries", action="store_true",
                    help="print each boundary's scanned mapped set")
    ap.add_argument("--explain", metavar="TYPE_SUBSTR",
                    help="dump every serving entry a matching type "
                         "escapes from, with witness chains")
    ap.add_argument("--format", choices=("text", "sarif"), default="text")
    args = ap.parse_args(argv)

    g = build_callgraph(args.paths or _default_paths())
    if args.list_boundaries:
        for kind, b in sorted(boundary_mappings(g).items()):
            print(f"{kind}: {b['rel']}::{b['fn']} (line {b['line']})")
            for k in sorted(b["mapped"]):
                print(f"  maps {_short(k)}")
        return 0
    if args.explain:
        esc, hop = escape_sets(g)
        entries = serving_entries(g)
        for q in sorted(entries, key=lambda q: entries[q]):
            for key, (rel, line, _oq, src) in sorted(
                    (esc.get(q) or {}).items()):
                if args.explain not in key:
                    continue
                print(f"{_short(key):28s} [{entries[q]}] from {rel}:{line}"
                      f" ({src})  {_chain(g, hop, q, key)}")
        return 0
    findings, _used = run_pass(g)
    if args.format == "sarif":
        import json

        from .sarif import to_sarif
        print(json.dumps(to_sarif(
            findings, {RULE_ID: "untyped exception escape to boundary"}),
            indent=2, sort_keys=True))
        return 1 if findings else 0
    for f in findings:
        print(f)
    if findings:
        print(f"\n{len(findings)} exception-escape finding(s): add a "
              f"typed boundary mapping, catch en route, or disable with "
              f"the invariant that makes the escape sanctioned.",
              file=sys.stderr)
        return 1
    print(f"errorflow clean: {len(serving_entries(g))} entries, "
          f"{len(g.defs)} defs analyzed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
