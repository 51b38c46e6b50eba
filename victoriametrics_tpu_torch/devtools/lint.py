"""Project lint engine (the `go vet` analog for this repo).

Rules live in sibling ``rules_*`` modules, one module per rule family;
each exposes ``RULES``, a list of objects with a ``rule_id``, a one-line
``summary`` and a ``check(ctx)`` generator yielding :class:`Finding`.

Usage::

    python -m victoriametrics_tpu_torch.devtools.lint victoriametrics_tpu_torch/
    python -m victoriametrics_tpu_torch.devtools.lint --update-baseline
    python -m victoriametrics_tpu_torch.devtools.lint --no-baseline file.py

Findings are ``path:line: VMTxxx message``.  A finding is silenced
either by an inline comment on the offending line::

    t = time.time()  # vmt: disable=VMT001

or by the checked-in grandfather baseline
(``devtools/lint_baseline.txt``, per-file per-rule counts — line-number
free so unrelated edits don't invalidate it).  The check fails only when
a (file, rule) pair exceeds its baselined count, so the suite starts
green and ratchets: fixing findings shrinks the baseline via
``--update-baseline``, new code can't add any.

The ratchet cuts both ways: a baseline entry whose findings no longer
fire is STALE debt shielding future regressions, so the CLI fails with
exit code 3 (distinct from 1 = new findings) until the baseline is
regenerated.

The port's copy of ``victoriametrics_tpu/devtools/lint.py``, whole but
for VMT006: ``rules_torch`` (host syncs inside the kernel wrappers)
takes the place of the reference's ``rules_jax``; and the walk skips
``_build/`` (the kernel libraries and checkouts unpacked for a chip
run).
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import io
import os
import re
import sys
import tokenize
from collections import Counter

_DEVTOOLS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(os.path.dirname(_DEVTOOLS_DIR))
DEFAULT_BASELINE = os.path.join(_DEVTOOLS_DIR, "lint_baseline.txt")

_SUPPRESS_RE = re.compile(r"#\s*vmt:\s*disable=([A-Za-z0-9_,\s]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str     # repo-root-relative when under the repo, else as given
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


def dotted_name(node) -> str | None:
    """"a.b.c" for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def normalize_path(path: str) -> str:
    """Repo-root-relative (the baseline key) when under the repo, else
    the path as given."""
    rel = os.path.relpath(os.path.abspath(path), REPO_ROOT)
    return path if rel.startswith("..") else rel.replace(os.sep, "/")


class FileContext:
    """One parsed source file handed to every rule."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.rel_path = normalize_path(path)
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        # line -> set of rule ids disabled on that line.  Only REAL
        # comment tokens count: a disable spelled inside a docstring or
        # string literal (rule documentation, examples) is inert
        self.suppressed: dict[int, set[str]] = {}
        # (line, rule) pairs whose disable comment actually silenced a
        # finding this run — VMT013 flags the ones that never fire
        self.used_suppressions: set[tuple[int, str]] = set()
        try:
            for tok in tokenize.generate_tokens(
                    io.StringIO(source).readline):
                if tok.type != tokenize.COMMENT:
                    continue
                m = _SUPPRESS_RE.search(tok.string)
                if m:
                    ids = {s.strip().upper()
                           for s in m.group(1).split(",")}
                    self.suppressed[tok.start[0]] = {s for s in ids if s}
        except tokenize.TokenError:  # parsed fine; tolerate odd tails
            pass

    def finding(self, node, rule: str, message: str) -> Finding:
        line = getattr(node, "lineno", 0) if not isinstance(node, int) else node
        return Finding(self.rel_path, line, rule, message)

    def is_suppressed(self, f: Finding) -> bool:
        if f.rule in self.suppressed.get(f.line, ()):
            self.used_suppressions.add((f.line, f.rule))
            return True
        return False


def all_rules() -> list:
    from . import (rules_locks, rules_metrics, rules_pyflaws, rules_threads,
                   rules_time, rules_torch)
    rules = []
    for mod in (rules_time, rules_pyflaws, rules_locks, rules_torch,
                rules_metrics, rules_threads):
        rules.extend(mod.RULES)
    return sorted(rules, key=lambda r: r.rule_id)


def iter_py_files(paths):
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
        else:
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", "_build")
                                 and not d.startswith("."))
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)


def lint_source(source: str, path: str = "<string>",
                rules=None) -> list[Finding]:
    """Lint one source string; returns unsuppressed findings."""
    ctx = FileContext(path, source)
    out = []
    for rule in rules if rules is not None else all_rules():
        for f in rule.check(ctx):
            if not ctx.is_suppressed(f):
                out.append(f)
    return sorted(out, key=lambda f: (f.path, f.line, f.rule))


def lint_paths(paths, rules=None,
               collect_ctxs: list | None = None) -> list[Finding]:
    """Lint files/dirs.  ``collect_ctxs`` (when a list) receives every
    successfully-parsed :class:`FileContext` — the whole-program checks
    (VMT013/VMT014) reuse them instead of re-parsing."""
    findings: list[Finding] = []
    for path in iter_py_files(paths):
        try:
            with open(path, encoding="utf-8") as fh:
                src = fh.read()
        except OSError as e:
            print(f"lint: cannot read {path}: {e}", file=sys.stderr)
            continue
        try:
            ctx = FileContext(path, src)
        except SyntaxError as e:
            findings.append(Finding(normalize_path(path), e.lineno or 0,
                                    "VMT000", f"syntax error: {e.msg}"))
            continue
        if collect_ctxs is not None:
            collect_ctxs.append(ctx)
        for rule in rules if rules is not None else all_rules():
            for f in rule.check(ctx):
                if not ctx.is_suppressed(f):
                    findings.append(f)
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


# -- whole-program checks (need every file, or files outside the lint) ------

STALE_DISABLE_RULE = "VMT013"
ENV_FLAG_RULE = "VMT014"

#: whole-program rule id -> one-line summary.  The per-file rules carry
#: their own ``summary``; --list-rules and the SARIF rule catalog need
#: the program passes' ids in one place too.
PROGRAM_RULE_SUMMARIES = {
    "VMT012": "blocking primitive reachable from a serving entry "
              "without a deadline seam (whole-program)",
    STALE_DISABLE_RULE: "stale '# vmt: disable=' comment that silences "
                        "nothing (whole-program)",
    ENV_FLAG_RULE: "VM_*/VMT_* env flag read in code but missing from "
                   "README.md (whole-program)",
    "VMT015": "field written from >=2 concurrency roots with no "
              "consistent guarding lock (whole-program)",
    "VMT016": "exception type reaching the HTTP/RPC boundary without "
              "a typed-status mapping (whole-program)",
}

#: an env-flag literal: VM_/VMT_ prefix then SCREAMING_SNAKE (rule ids
#: like "VMT012" don't match — no underscore after the prefix)
_FLAG_RE = re.compile(r"^VMT?_[A-Z][A-Z0-9_]*$")
_README = os.path.join(REPO_ROOT, "README.md")


def stale_disable_findings(ctxs, extra_used: dict | None = None,
                           ran_rules: set | None = None) -> list[Finding]:
    """VMT013: a ``# vmt: disable=X`` comment that silenced nothing.

    Dead disables are worse than dead code — they LOOK like an active
    exemption and will silently swallow the next real finding on that
    line.  Only judged for rule ids that actually ran this invocation
    (``ran_rules``); program-pass suppressions consumed outside the
    per-file machinery arrive via ``extra_used``
    (``{rel_path: {(line, rule), ...}}``)."""
    if ran_rules is None:
        ran_rules = {r.rule_id for r in all_rules()}
    out = []
    for ctx in ctxs:
        used = set(ctx.used_suppressions)
        if extra_used:
            used |= extra_used.get(ctx.rel_path, set())
        for line, rules in sorted(ctx.suppressed.items()):
            for rule in sorted(rules):
                if rule == STALE_DISABLE_RULE or rule not in ran_rules:
                    continue
                if (line, rule) not in used:
                    f = Finding(
                        ctx.rel_path, line, STALE_DISABLE_RULE,
                        f"stale '# vmt: disable={rule}': {rule} no "
                        f"longer fires here; drop the comment (it would "
                        f"silently swallow the next real finding)")
                    if not ctx.is_suppressed(f):
                        out.append(f)
    return out


def readme_flags() -> set[str]:
    """Every VM_*/VMT_* token mentioned anywhere in README.md."""
    try:
        with open(_README, encoding="utf-8") as fh:
            text = fh.read()
    except OSError:
        return set()
    return {t for t in re.findall(r"\bVMT?_[A-Z][A-Z0-9_]*\b", text)
            if _FLAG_RE.match(t)}


def env_flag_inventory(ctxs) -> dict[str, list[tuple[str, int]]]:
    """flag -> sorted (rel_path, line) occurrences, from string literals
    in the code (docstrings/comments don't count: the regex anchors the
    WHOLE constant, and only env-flag reads carry the bare token)."""
    inv: dict[str, list[tuple[str, int]]] = {}
    for ctx in ctxs:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and \
                    _FLAG_RE.match(node.value):
                inv.setdefault(node.value, []).append(
                    (ctx.rel_path, node.lineno))
    for locs in inv.values():
        locs.sort()
    return inv


def env_flag_findings(ctxs) -> list[Finding]:
    """VMT014: a VM_*/VMT_* flag read in code but absent from README.md.

    The README flag table is the operator surface — a knob that isn't
    in it effectively doesn't exist (nobody can discover it), and knobs
    documented nowhere rot into booby traps.  One finding per flag, at
    its first occurrence."""
    documented = readme_flags()
    by_rel = {ctx.rel_path: ctx for ctx in ctxs}
    out = []
    for flag, locs in sorted(env_flag_inventory(ctxs).items()):
        if flag in documented:
            continue
        rel, line = locs[0]
        f = Finding(rel, line, ENV_FLAG_RULE,
                    f"env flag {flag} is read here but missing from "
                    f"README.md's flag table; document it (or rename "
                    f"it out of the VM_*/VMT_* namespace)")
        if not by_rel[rel].is_suppressed(f):
            out.append(f)
    return out


# -- baseline ---------------------------------------------------------------

def load_baseline(path: str) -> Counter:
    """Baseline lines are ``relpath:RULE:count``; '#' starts a comment."""
    counts: Counter = Counter()
    if not os.path.exists(path):
        return counts
    with open(path, encoding="utf-8") as fh:
        for raw in fh:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            try:
                rel, rule, n = line.rsplit(":", 2)
                counts[(rel, rule)] = int(n)
            except ValueError:
                print(f"lint: bad baseline line skipped: {line!r}",
                      file=sys.stderr)
    return counts


def write_baseline(path: str, findings: list[Finding],
                   linted_files: set[str] | None = None) -> None:
    """Rewrite the baseline. When ``linted_files`` is given (a subset
    lint), entries for files OUTSIDE the subset are carried over
    unchanged instead of being silently dropped."""
    counts = Counter((f.path, f.rule) for f in findings)
    if linted_files is not None:
        for key, n in load_baseline(path).items():
            if key[0] not in linted_files:
                counts[key] = n
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("# Grandfathered lint findings: relpath:RULE:count.\n"
                 "# Regenerate with: python -m victoriametrics_tpu_torch.devtools."
                 "lint --update-baseline\n")
        for (rel, rule), n in sorted(counts.items()):
            if n:
                fh.write(f"{rel}:{rule}:{n}\n")


def new_findings(findings: list[Finding], baseline: Counter) -> list[Finding]:
    """Findings in (file, rule) groups that exceed their baselined count.

    The whole group is returned when it exceeds (line numbers drift, so
    individual findings can't be matched against the baseline)."""
    groups: dict[tuple, list[Finding]] = {}
    for f in findings:
        groups.setdefault((f.path, f.rule), []).append(f)
    out = []
    for key, fs in groups.items():
        if len(fs) > baseline.get(key, 0):
            out.extend(fs)
    return sorted(out, key=lambda f: (f.path, f.line, f.rule))


def stale_baseline_entries(findings: list[Finding], baseline: Counter,
                           linted_files: set[str] | None = None) -> list[tuple]:
    """Baseline entries whose count exceeds what the lint found — only
    meaningful for files that were actually linted this run."""
    counts = Counter((f.path, f.rule) for f in findings)
    return sorted(k for k, n in baseline.items()
                  if counts.get(k, 0) < n and
                  (linted_files is None or k[0] in linted_files))


# -- CLI --------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m victoriametrics_tpu_torch.devtools.lint",
        description="Project-specific AST lint (rules VMT001..VMT011).")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: the package)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline file (default: devtools/lint_baseline.txt)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignore the baseline")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from current findings")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--list-flags", action="store_true",
                    help="print the VM_*/VMT_* env-flag inventory "
                         "(flag -> read sites) and exit")
    ap.add_argument("--no-program-passes", action="store_true",
                    help="skip the whole-program passes (deadline taint, "
                         "lockset, errorflow, wire schema) on a "
                         "full-package run")
    ap.add_argument("--scoped-program-passes", action="store_true",
                    help="with an explicit path list, still run the "
                         "call-graph passes (built over the whole "
                         "package) but report only their findings in "
                         "the listed files")
    ap.add_argument("--format", choices=("text", "sarif"), default="text",
                    help="finding output: text lines (default) or one "
                         "SARIF 2.1.0 log on stdout (same exit codes)")
    args = ap.parse_args(argv)

    if args.list_rules:
        for r in all_rules():
            print(f"{r.rule_id}  {r.summary}")
        for rid, summary in sorted(PROGRAM_RULE_SUMMARIES.items()):
            print(f"{rid}  {summary}")
        return 0

    # the whole-program passes only make sense over the whole package:
    # an explicit path list lints just those files (fast editor loop)
    full_run = not args.paths
    paths = args.paths or [os.path.join(REPO_ROOT, "victoriametrics_tpu_torch")]
    linted = {normalize_path(p) for p in iter_py_files(paths)}
    ctxs: list[FileContext] = []
    findings = lint_paths(paths, collect_ctxs=ctxs)

    if args.list_flags:
        if not full_run:
            ctxs = []
            lint_paths([os.path.join(REPO_ROOT, "victoriametrics_tpu_torch")],
                       rules=[], collect_ctxs=ctxs)
        documented = readme_flags()
        for flag, locs in sorted(env_flag_inventory(ctxs).items()):
            mark = " " if flag in documented else "!"
            sites = ", ".join(f"{rel}:{line}" for rel, line in locs[:3])
            if len(locs) > 3:
                sites += f", +{len(locs) - 3} more"
            print(f"{mark} {flag:32s} {sites}")
        print(f"\n('!' = missing from README.md's flag table)")
        return 0

    ran_rules = {r.rule_id for r in all_rules()}
    extra_used: dict[str, set] = {}
    schema_exit = 0
    if full_run:
        findings.extend(env_flag_findings(ctxs))
        ran_rules.add(ENV_FLAG_RULE)
        if not args.no_program_passes:
            from . import deadline_taint, errorflow, lockset, wireschema
            from .callgraph import build_callgraph
            # ONE shared graph: the three call-graph passes see the
            # same build (and pay its cost once)
            g = build_callgraph(
                [os.path.join(REPO_ROOT, "victoriametrics_tpu_torch")])
            for mod in (deadline_taint, lockset, errorflow):
                pass_findings, pass_used = mod.run_pass(g)
                findings.extend(pass_findings)
                for rel, pairs in pass_used.items():
                    extra_used.setdefault(rel, set()).update(pairs)
                ran_rules.add(mod.RULE_ID)
            schema_exit, schema_msgs, _ = wireschema.check()
            for m in schema_msgs:
                print(f"wireschema: {m}", file=sys.stderr)
        findings.extend(stale_disable_findings(ctxs, extra_used,
                                               ran_rules))
        findings.sort(key=lambda f: (f.path, f.line, f.rule))
    elif args.scoped_program_passes and not args.no_program_passes:
        # editor/changed-only loop: the graph is whole-package (the
        # passes are interprocedural — a subset graph would lie), the
        # report is scoped to the listed files.  VMT013 is judged only
        # on full runs, so consumed suppressions need no merging here.
        from . import deadline_taint, errorflow, lockset
        from .callgraph import build_callgraph
        g = build_callgraph(
            [os.path.join(REPO_ROOT, "victoriametrics_tpu_torch")])
        for mod in (deadline_taint, lockset, errorflow):
            pass_findings, _used = mod.run_pass(g)
            findings.extend(f for f in pass_findings if f.path in linted)
        findings.sort(key=lambda f: (f.path, f.line, f.rule))

    if args.update_baseline:
        write_baseline(args.baseline, findings, linted)
        print(f"baseline updated: {len(findings)} finding(s) grandfathered "
              f"-> {args.baseline}")
        return 0

    stale = []
    if args.no_baseline:
        fresh = findings
    else:
        baseline = load_baseline(args.baseline)
        fresh = new_findings(findings, baseline)
        stale = stale_baseline_entries(findings, baseline, linted)

    if args.format == "sarif":
        import json

        from .sarif import to_sarif
        summaries = {r.rule_id: r.summary for r in all_rules()}
        summaries.update(PROGRAM_RULE_SUMMARIES)
        print(json.dumps(to_sarif(fresh, summaries),
                         indent=2, sort_keys=True))
    else:
        for f in fresh:
            print(f)
    if fresh:
        print(f"\n{len(fresh)} new finding(s) "
              f"({len(findings)} total incl. baseline). "
              f"Fix, add '# vmt: disable=<RULE>' with a reason, or "
              f"--update-baseline if truly grandfathered.", file=sys.stderr)
        return 1
    if schema_exit:
        # wireschema's own message (breaking vs regenerate) already
        # printed above; its exit codes (4 breaking, 2 additive-drift)
        # are distinct from lint's 1/3
        return schema_exit
    if stale:
        for rel, rule in stale:
            print(f"stale baseline entry: {rel}:{rule} no longer fires "
                  f"at its baselined count", file=sys.stderr)
        print(f"\nBASELINE STALE: {len(stale)} grandfathered entr"
              f"{'y' if len(stale) == 1 else 'ies'} exceed what the lint "
              f"finds; the ratchet has slack that would hide regressions. "
              f"Regenerate with --update-baseline.", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
