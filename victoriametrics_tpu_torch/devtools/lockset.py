"""VMT015 — static lockset / guarded-by inference over the call graph
(the RacerD-shaped half of the `go test -race` replacement; the dynamic
half is devtools/racetrace.py, which only sees interleavings that
actually execute).

For every mutable field (``self.attr`` plus module-level mutable
globals) the pass collects each access with the *lockset* held at that
access: the locks lexically held inside the function (``with lock:``
regions, identified by their ``make_lock``/``make_rlock`` registry
name) plus the locks guaranteed held on entry — the intersection,
over every call edge reaching the function from the current root, of
the caller's entry lockset and the locks held at the call site.

Concurrency roots are the places a fresh thread of control enters the
code:

- the serving entries deadline-taint already discovers (HTTP routes,
  RPC dispatch dicts, matstream advance), and
- every target of a ``thread``/``submit`` edge — service threads and
  pool-worker units run concurrently with their spawner, so each
  target is its own root and lock context does NOT flow across the
  spawn edge.

A field is flagged when it has at least one write reachable from a
root, is touched from **two or more distinct roots**, and the
intersection of the locksets over *all* its accesses is empty — i.e.
no single lock consistently guards it.  Findings carry both witness
chains (one per root), RacerD-style, and anchor at the first
unguarded write so the fix site is the report site.

Exemptions (by construction, not suppression):

- accesses inside ``__init__``/``__new__`` — the object is
  thread-local until published, and fields only ever written during
  construction are immutable-after-publish;
- lock-looking fields themselves and bound methods;
- fields never written outside construction (read-only config);
- fields of classes that own no lock at all.  This is RacerD's
  ownership bet adapted to this codebase: a class that never
  constructs or holds a lock has made no thread-safety claim — its
  instances are per-request value objects (``Row``, wire ``Writer``,
  ring blocks) whose confinement VMT009 and code review police, and
  flagging every such field would drown the signal.  A class that
  DOES own a lock has declared itself shared, so every one of its
  mutable fields must be consistently guarded.  Module-level globals
  are shared by construction and always eligible.

Real findings get FIXED and pinned by a seeded
``DeterministicScheduler`` regression test; benign ones (idempotent
memo double-creates, monotonic stats tolerating a lost increment)
carry ``# vmt: disable=VMT015`` with a one-line invariant argument on
any access site of the field.  VMT013 flags the comment when the
finding stops firing.

The port's copy of ``victoriametrics_tpu/devtools/lockset.py``, whole.
"""

from __future__ import annotations

import argparse
import os
import sys

from .callgraph import CallGraph, build_callgraph, source_suppressed
from .deadline_taint import find_entries
from .lint import Finding

RULE_ID = "VMT015"


# -- roots ------------------------------------------------------------------

def find_roots(g: CallGraph) -> dict[str, str]:
    """qname -> human-readable description of the concurrency root."""
    roots = dict(find_entries(g))
    for q in sorted(g.edges):
        for e in g.edges[q]:
            if e.kind in ("thread", "submit", "cbref") and \
                    e.target in g.defs:
                fd = g.defs[e.target]
                roots.setdefault(e.target, f"{e.kind} {fd.name}")
    return roots


# -- per-root lockset propagation -------------------------------------------

def _root_closure(g: CallGraph, root: str):
    """(entry_lockset, parent) maps for everything reachable from
    ``root`` via call/ref edges.  ``entry_lockset[q]`` is the set of
    locks guaranteed held whenever ``q`` runs on behalf of this root:
    the intersection over all discovered call paths.  Monotone
    (locksets only shrink), so the worklist terminates."""
    entry: dict[str, frozenset] = {root: frozenset()}
    parent: dict[str, tuple | None] = {root: None}
    work = [root]
    while work:
        q = work.pop()
        base = entry[q]
        for e in g.callees(q):
            if e.kind not in ("call", "ref") or e.target not in g.defs:
                continue
            new = frozenset(base | set(e.locks))
            old = entry.get(e.target)
            if old is None:
                entry[e.target] = new
                parent[e.target] = (q, e.lineno)
                work.append(e.target)
            else:
                merged = old & new
                if merged != old:
                    entry[e.target] = merged
                    work.append(e.target)
    return entry, parent


def _chain(g: CallGraph, parent: dict, q: str) -> str:
    names = []
    cur: str | None = q
    while cur is not None:
        names.append(g.defs[cur].name if cur in g.defs else cur)
        nxt = parent.get(cur)
        cur = nxt[0] if nxt else None
    names.reverse()
    if len(names) > 5:
        names = names[:2] + ["..."] + names[-2:]
    return " -> ".join(names)


# -- the pass ---------------------------------------------------------------

def _short(lock: str) -> str:
    return lock.rpartition("/")[2]


def locked_classes(g: CallGraph) -> set[str]:
    """Class qnames that own a lock: a ``self.attr = make_lock(...)``
    binding, or any ``with self.<lockish>`` region in a method (covers
    bare ``threading.Lock()`` attributes via the lexical fallback
    identity ``cls_q.attr``)."""
    out = {scope for (scope, _attr) in g.lock_names if "::" in scope}
    for accs in g.accesses.values():
        for (_field, _kind, _line, locks) in accs:
            for lid in locks:
                if "::" in lid and "." in lid.rpartition("::")[2]:
                    out.add(lid.rpartition(".")[0])
    return out


def collect_accesses(g: CallGraph, roots: dict[str, str]):
    """field -> [(root, qname, kind, rel, line, lockset)] for every
    access reachable from a concurrency root."""
    eligible_cls = locked_classes(g)

    def eligible(field: str) -> bool:
        if "::" not in field:
            return False
        tail = field.rpartition("::")[2]
        if "." not in tail:
            return True    # module global: shared by construction
        return field.rpartition(".")[0] in eligible_cls

    fields: dict[str, list] = {}
    parents: dict[str, dict] = {}
    for r in sorted(roots):
        if r not in g.defs:
            continue
        entry, parent = _root_closure(g, r)
        parents[r] = parent
        for q, base in entry.items():
            fd = g.defs[q]
            if fd.name in ("__init__", "__new__", "__del__"):
                continue   # construction: thread-local until published
            for (field, kind, line, locks) in g.accesses.get(q, ()):
                if not eligible(field):
                    continue
                fields.setdefault(field, []).append(
                    (r, q, kind, fd.rel_path, line,
                     frozenset(base | set(locks))))
    return fields, parents


def run_pass(g: CallGraph | None = None, paths=None):
    """Returns (findings, used_suppressions); the latter is
    ``{rel_path: {(line, RULE_ID), ...}}`` for VMT013's bookkeeping."""
    if g is None:
        g = build_callgraph(paths or _default_paths())
    roots = find_roots(g)
    fields, parents = collect_accesses(g, roots)

    findings: list[Finding] = []
    used: dict[str, set] = {}
    for field in sorted(fields):
        accs = fields[field]
        root_set = sorted({a[0] for a in accs})
        accs = sorted(accs, key=lambda a: (a[3], a[4], a[2], a[0]))
        writes = [a for a in accs if a[2] == "write"]
        if not writes or len(root_set) < 2:
            continue
        # the race condition proper, pairwise: a write and another
        # access on DIFFERENT roots whose locksets are disjoint — no
        # common lock orders the two
        pair = None
        for w in sorted(writes, key=lambda a: (len(a[5]), a[3], a[4])):
            for a2 in accs:
                if a2[0] != w[0] and not (w[5] & a2[5]):
                    pair = (w, a2)
                    break
            if pair:
                break
        if pair is None:
            continue   # every conflicting pair shares a lock
        # a disable on ANY access site of the field suppresses it (the
        # invariant argument reads best next to the access it excuses)
        sites = sorted({(a[3], a[4]) for a in accs})
        sup = [(rel, ln) for rel, ln in sites
               if source_suppressed(g, rel, ln, RULE_ID)]
        if sup:
            for rel, ln in sup:
                used.setdefault(rel, set()).add((ln, RULE_ID))
            continue
        bad, other = pair
        held = ", ".join(sorted(_short(x) for x in bad[5])) or "none"
        oheld = ", ".join(sorted(_short(x) for x in other[5])) or "none"
        msg = (f"field {_short(field)} has no consistent guard across "
               f"{len(root_set)} concurrency roots: "
               f"write here holds {{{held}}} on "
               f"[{roots[bad[0]]}] via {_chain(g, parents[bad[0]], bad[1])}"
               f"; {other[2]} at {other[3]}:{other[4]} holds "
               f"{{{oheld}}} on [{roots[other[0]]}] via "
               f"{_chain(g, parents[other[0]], other[1])}"
               " — guard every access with one lock, or disable with "
               "the invariant that makes the race benign")
        findings.append(Finding(bad[3], bad[4], RULE_ID, msg))
    findings.sort(key=lambda f: (f.path, f.line))
    return findings, used


def _default_paths():
    from .lint import REPO_ROOT
    return [os.path.join(REPO_ROOT, "victoriametrics_tpu_torch")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m victoriametrics_tpu_torch.devtools.lockset",
        description="VMT015: fields written from >=2 concurrency roots "
                    "with no consistent guarding lock (static lockset "
                    "inference over the project call graph).")
    ap.add_argument("paths", nargs="*")
    ap.add_argument("--list-roots", action="store_true")
    ap.add_argument("--explain", metavar="FIELD_SUBSTR",
                    help="dump every reachable access of matching "
                         "fields with roots and locksets")
    ap.add_argument("--format", choices=("text", "sarif"), default="text")
    args = ap.parse_args(argv)

    g = build_callgraph(args.paths or _default_paths())
    if args.list_roots:
        for q, why in sorted(find_roots(g).items(), key=lambda kv: kv[1]):
            print(f"{why:40s} {q}")
        return 0
    if args.explain:
        fields, _parents = collect_accesses(g, find_roots(g))
        roots = find_roots(g)
        for field in sorted(fields):
            if args.explain not in field:
                continue
            print(field)
            for (r, q, kind, rel, line, ls) in sorted(
                    fields[field], key=lambda a: (a[3], a[4])):
                locks = ", ".join(sorted(_short(x) for x in ls)) or "-"
                print(f"  {kind:5s} {rel}:{line}  [{roots[r]}]  "
                      f"locks={{{locks}}}")
        return 0
    findings, _used = run_pass(g)
    if args.format == "sarif":
        import json

        from .sarif import to_sarif
        print(json.dumps(to_sarif(
            findings, {RULE_ID: "unguarded cross-root field access"}),
            indent=2, sort_keys=True))
        return 1 if findings else 0
    for f in findings:
        print(f)
    if findings:
        print(f"\n{len(findings)} lockset finding(s): fix the race or "
              f"disable with the invariant that makes it benign.",
              file=sys.stderr)
        return 1
    print(f"lockset clean: {len(find_roots(g))} roots, "
          f"{len(g.defs)} defs analyzed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
