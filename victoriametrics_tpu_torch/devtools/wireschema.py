"""Wire/format schema ratchet (the compatibility contract, made checkable).

The cluster plane speaks a hand-evolved binary protocol whose
compatibility rules used to live only in prose: search_v1 alone grew
four generations of trailing fields (trace flag -> budget_ms -> or_sets
-> RingConfig), each guarded by bespoke ``Reader.remaining`` tolerance,
and the on-disk formats (metadata.json, parts.json, ring_exempt.bin,
adopted_mid.json) carry the same implicit old-reader/new-writer rules.
This module EXTRACTS those schemas from the marshal/unmarshal code
itself — field order, op types, repeat groups, optionality, and whether
the reader tolerates a field's absence — and ratchets them against the
committed ``devtools/wire_schema.lock.json``.

Extraction is a symbolic, order-preserving walk of the AST:

- **server request schema** — reader ops (``r.u64()``, ``r.bytes_()``,
  ...) in each RPC handler, with module/nested helper calls that take
  the reader (``_read_tenant(r)``, ``_read_or_sets(r)``) inlined, and
  guard context tracked: an op under ``if r.remaining`` (or after an
  early ``return`` on ``not r.remaining``) is an *optional, tolerated*
  trailing field — exactly the rolling-upgrade contract.
- **server response schema** — writer ops (op calls WITH arguments) in
  the handler and its nested frame generators, ``_meta_frame`` inlined.
- **client request schema** — writer ops in the function that invokes
  ``.call("method", w)`` / ``.call_stream(...)``, helpers inlined
  (helpers that themselves issue RPC calls are fallback paths, not part
  of this request, and are NOT inlined).
- **persisted formats** — json dict-literal keys at the write sites vs
  required (``d["k"]``) and tolerated (``d.get("k")`` / KeyError-guarded)
  keys at the read sites; ring_exempt.bin's varint record layout with
  its torn-tail tolerance.

Checks, in increasing severity:

- **pairing** (lockfile-independent): the client's written fields must
  match the server's read fields position-by-position (op + repeat
  group); a writer field the paired reader never consumes is breaking.
  Same for format writer keys vs reader-required keys.
- **ratchet** (vs the lockfile): field removal, reorder, a new
  NON-trailing field, a required new trailing field, or LOST trailing
  tolerance (an optional field becoming required strands every old
  peer) — all breaking, exit :data:`EXIT_BREAKING` (4).  Purely
  additive trailing extensions exit :data:`EXIT_ADDITIVE` (2) until the
  lockfile is regenerated with ``--update-schema`` (which refuses
  breaking diffs unless ``--allow-breaking`` spells out the intent).

ROADMAP items 4-5 (anti-entropy, streamed part transfer, persistentqueue
chunk format) add more wire and disk formats; they land by extending
:data:`RPC_MODULES`/:data:`FORMATS` so the ratchet covers them on day
one.

The port's copy of ``victoriametrics_tpu/devtools/wireschema.py``,
whole.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import sys

from .lint import REPO_ROOT, normalize_path

LOCKFILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "wire_schema.lock.json")

EXIT_OK = 0
EXIT_ADDITIVE = 2     # schema grew (trailing, tolerated): --update-schema
EXIT_BREAKING = 4     # compatibility break: old peers/files would misparse

#: Writer/Reader op vocabulary (parallel/rpc.py): zero-arg calls on the
#: tracked reader are reads, op calls WITH arguments are writes
OPS = ("u64", "i64", "f64", "bytes_", "str_", "array")

#: modules holding RPC marshal/unmarshal code
RPC_MODULES = (
    "victoriametrics_tpu_torch/parallel/cluster_api.py",
    "victoriametrics_tpu_torch/parallel/rpc.py",
)

#: persisted formats: extraction sites for writer keys and reader
#: required/tolerated keys (see _extract_formats)
FORMATS = {
    "metadata.json": {
        "kind": "json",
        # dict literal passed to write_meta_json + keys the fs helper
        # itself injects (meta["meta_crc"] = ...)
        "write_dict_args": [
            ("victoriametrics_tpu_torch/storage/part.py", "write_meta_json", 1)],
        "write_key_assigns": [
            ("victoriametrics_tpu_torch/utils/fs.py", "write_meta_json", "meta")],
        # vars assigned from these calls (or params with these names)
        # are format dicts; d["k"] reads are required, d.get("k")
        # tolerated
        "read_seed_calls": {
            "victoriametrics_tpu_torch/storage/part.py": ("load_meta_json",),
            "victoriametrics_tpu_torch/utils/fs.py": ("load_meta_json",)},
        "read_seed_params": {
            "victoriametrics_tpu_torch/utils/fs.py": ("meta",)},
    },
    "parts.json": {
        "kind": "json",
        "write_dict_args": [
            ("victoriametrics_tpu_torch/storage/partition.py", "dump", 0)],
        "read_seed_calls": {
            "victoriametrics_tpu_torch/storage/partition.py": ("load",)},
    },
    # downsampled-tier manifest (storage/downsample.py): written via the
    # same write_meta_json/meta_crc seam as metadata.json, committed
    # after part publication (downsample:post_rename_pre_manifest)
    "tier.json": {
        "kind": "json",
        "write_dict_args": [
            ("victoriametrics_tpu_torch/storage/downsample.py",
             "write_meta_json", 1)],
        "write_key_assigns": [
            ("victoriametrics_tpu_torch/utils/fs.py", "write_meta_json", "meta")],
        "read_seed_calls": {
            "victoriametrics_tpu_torch/storage/downsample.py":
                ("load_meta_json",),
            "victoriametrics_tpu_torch/utils/fs.py": ("load_meta_json",)},
        "read_seed_params": {
            "victoriametrics_tpu_torch/utils/fs.py": ("meta",)},
    },
    "adopted_mid.json": {
        "kind": "json",
        "only_funcs": ("_persist_adopted_watermark",
                       "_load_adopted_watermark"),
        "write_dict_args": [
            ("victoriametrics_tpu_torch/storage/storage.py", "dump", 0)],
        "read_seed_calls": {
            "victoriametrics_tpu_torch/storage/storage.py": ("load",)},
    },
    "ring_config": {
        "kind": "json",
        "write_dict_args": [
            ("victoriametrics_tpu_torch/parallel/ringfilter.py", "dumps", 0)],
        "read_seed_calls": {
            "victoriametrics_tpu_torch/parallel/ringfilter.py": ("loads",)},
    },
    "ring_exempt.bin": {
        "kind": "varint_records",
        "module": "victoriametrics_tpu_torch/storage/storage.py",
        "writer_func": "add_ring_exempt_names",
        "reader_func": "_load_ring_exempt",
    },
    # health_v1 RPC response body: built incrementally as a
    # local dict (out = {...}; out["k"] = ...) by local_health, widened
    # by the cluster_health roll-up, and tagged with the node name by
    # the fan-out.  The authoritative consumers are operators and
    # dashboards hitting /api/v1/status/health — external_readers keeps
    # the dead-writer-key pairing check from demanding an in-repo read
    # of every key — while the in-repo roll-up still ratchets what it
    # reads back from the nodes (verdict/reasons stay tolerated, never
    # required: an old node answering health_v1 without them must keep
    # working).
    "health_v1_report": {
        "kind": "json",
        "external_readers": True,
        "write_dict_assigns": [
            ("victoriametrics_tpu_torch/query/sloplane.py",
             "local_health", "out"),
            ("victoriametrics_tpu_torch/query/sloplane.py",
             "cluster_health", "out")],
        "write_key_assigns": [
            ("victoriametrics_tpu_torch/parallel/cluster_api.py", "one", "rep")],
        "read_seed_params": {
            "victoriametrics_tpu_torch/query/sloplane.py": ("rep",)},
    },
    # incident record: frozen once at burn-breach time by
    # _freeze_incident, id-stamped by IncidentRing.open, then served
    # verbatim over /api/v1/status/incidents — the diagnosis blob keys
    # (objective, topQueries, tenantUsage, ...) are read by whoever
    # triages the incident, not by repo code, hence external_readers.
    # The ring's own reads (id/slo required; the summary projection's
    # .get()s tolerated) still ratchet: removing a key an old record
    # carries is breaking.
    "incident_record": {
        "kind": "json",
        "external_readers": True,
        "write_dict_assigns": [
            ("victoriametrics_tpu_torch/query/sloplane.py",
             "_freeze_incident", "rec")],
        "write_key_assigns": [
            ("victoriametrics_tpu_torch/query/sloplane.py", "open", "rec"),
            ("victoriametrics_tpu_torch/query/sloplane.py", "resolve", "rec")],
        "read_seed_params": {
            "victoriametrics_tpu_torch/query/sloplane.py": ("rec",)},
    },
}


def _load_sources(sources=None) -> dict[str, str]:
    """rel_path -> source for every module the extraction touches.
    ``sources`` overrides individual files (the mutation tests inject a
    reordered field without touching the tree)."""
    rels = set(RPC_MODULES)
    for spec in FORMATS.values():
        for key in ("write_dict_args", "write_key_assigns",
                    "write_dict_assigns"):
            rels.update(s[0] for s in spec.get(key, ()))
        rels.update(spec.get("read_seed_calls", {}))
        rels.update(spec.get("read_seed_params", {}))
        if "module" in spec:
            rels.add(spec["module"])
    out = {}
    for rel in sorted(rels):
        if sources is not None and rel in sources:
            out[rel] = sources[rel]
            continue
        path = os.path.join(REPO_ROOT, rel)
        with open(path, encoding="utf-8") as fh:
            out[rel] = fh.read()
    return out


# -- field model ------------------------------------------------------------

def _field(op, via=None, repeat=False, optional=False, guard=None):
    f = {"op": op}
    if via:
        f["via"] = via
    if repeat:
        f["repeat"] = True
    if optional:
        f["optional"] = True
    if guard:
        f["guard"] = guard
    return f


def _mentions_remaining(test, reader: str | None) -> bool:
    if reader is None:
        return False
    for n in ast.walk(test):
        if isinstance(n, ast.Attribute) and n.attr == "remaining" and \
                isinstance(n.value, ast.Name) and n.value.id == reader:
            return True
    return False


class _OpScanner:
    """Order-preserving reader/writer op extraction for one function.

    ``reader`` is the tracked Reader param name (None when extracting
    writer-only).  Helpers (same-module defs) are inlined: for reader
    ops only when the tracked reader is passed through; for writer ops
    unless the helper issues its own RPC call (a fallback path)."""

    def __init__(self, helpers: dict[str, ast.AST], want: str):
        self.helpers = helpers
        self.want = want            # "read" | "write"
        self.fields: list[dict] = []
        self._stack: list[str] = []  # helper recursion guard

    def scan_function(self, func, reader: str | None, via=None,
                      repeat=False, optional=False, guard=None):
        self._stmts(func.body, reader, via, repeat, optional, guard)

    def _stmts(self, stmts, reader, via, repeat, optional, guard):
        # an early `return` guarded on `not r.remaining` makes every
        # field BELOW it optional: old peers stop the frame here
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # nested frame generators: their yields ARE the wire
                self._stmts(st.body, reader, via, repeat, optional, guard)
                continue
            if isinstance(st, (ast.For, ast.AsyncFor)):
                self._expr(st.iter, reader, via, repeat, optional, guard)
                self._stmts(st.body, reader, via, True, optional, guard)
                self._stmts(st.orelse, reader, via, repeat, optional,
                            guard)
                continue
            if isinstance(st, ast.While):
                self._expr(st.test, reader, via, repeat, optional, guard)
                self._stmts(st.body, reader, via, True, optional, guard)
                continue
            if isinstance(st, ast.If):
                g = "remaining" if _mentions_remaining(st.test, reader) \
                    else guard or "value"
                self._expr(st.test, reader, via, repeat, optional, guard)
                ends_flow = st.body and isinstance(
                    st.body[-1], (ast.Return, ast.Raise, ast.Continue,
                                  ast.Break))
                self._stmts(st.body, reader, via, repeat, True, g)
                self._stmts(st.orelse, reader, via, repeat, True, g)
                if ends_flow and _mentions_remaining(st.test, reader):
                    # everything after `if not r.remaining: return` is
                    # a tolerated trailing extension
                    optional, guard = True, "remaining"
                continue
            if isinstance(st, ast.Try):
                self._stmts(st.body, reader, via, repeat, optional, guard)
                for h in st.handlers:
                    self._stmts(h.body, reader, via, repeat, True,
                                guard or "value")
                self._stmts(st.finalbody, reader, via, repeat, optional,
                            guard)
                continue
            for child in ast.iter_child_nodes(st):
                self._expr(child, reader, via, repeat, optional, guard)

    def _expr(self, node, reader, via, repeat, optional, guard):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return
        if isinstance(node, ast.IfExp):
            g = "remaining" if _mentions_remaining(node.test, reader) \
                else guard or "value"
            self._expr(node.test, reader, via, repeat, optional, guard)
            self._expr(node.body, reader, via, repeat, True, g)
            self._expr(node.orelse, reader, via, repeat, True, g)
            return
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            for gen in node.generators:
                self._expr(gen.iter, reader, via, repeat, optional, guard)
            elts = [node.key, node.value] if isinstance(node, ast.DictComp) \
                else [node.elt]
            for e in elts:
                self._expr(e, reader, via, True, optional, guard)
            return
        if isinstance(node, ast.Call):
            self._call(node, reader, via, repeat, optional, guard)
            return
        for child in ast.iter_child_nodes(node):
            self._expr(child, reader, via, repeat, optional, guard)

    def _call(self, node, reader, via, repeat, optional, guard):
        f = node.func
        # evaluation order: receiver/args first (w.u64(a).u64(b) chains
        # emit the inner op before the outer)
        for child in ast.iter_child_nodes(f):
            self._expr(child, reader, via, repeat, optional, guard)
        for a in node.args:
            self._expr(a, reader, via, repeat, optional, guard)
        for kw in node.keywords:
            self._expr(kw.value, reader, via, repeat, optional, guard)

        if isinstance(f, ast.Attribute) and f.attr in OPS:
            is_read = not node.args
            if self.want == "read" and is_read and \
                    self._reader_rooted(f.value, reader):
                self.fields.append(_field(f.attr, via, repeat, optional,
                                          guard))
            elif self.want == "write" and not is_read:
                self.fields.append(_field(f.attr, via, repeat, optional,
                                          guard))
            return

        # helper inlining
        name = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else None)
        helper = self.helpers.get(name) if name else None
        if helper is None or name in self._stack:
            return
        if self.want == "read":
            # only when the tracked reader is passed through
            params = [a.arg for a in helper.args.args
                      if a.arg not in ("self", "cls")]
            sub_reader = None
            for i, a in enumerate(node.args):
                if isinstance(a, ast.Name) and a.id == reader and \
                        i < len(params):
                    sub_reader = params[i]
                    break
            if sub_reader is None:
                return
            self._stack.append(name)
            self._stmts(helper.body, sub_reader, via or name, repeat,
                        optional, guard)
            self._stack.pop()
        else:
            if _issues_rpc_call(helper):
                return  # fallback path issuing its own request
            self._stack.append(name)
            self._stmts(helper.body, None, via or name, repeat, optional,
                        guard)
            self._stack.pop()

    @staticmethod
    def _reader_rooted(value, reader) -> bool:
        return reader is not None and isinstance(value, ast.Name) and \
            value.id == reader


def _issues_rpc_call(func) -> bool:
    for n in ast.walk(func):
        if isinstance(n, ast.Call) and \
                isinstance(n.func, ast.Attribute) and \
                n.func.attr in ("call", "call_stream") and n.args and \
                isinstance(n.args[0], ast.Constant) and \
                isinstance(n.args[0].value, str):
            return True
    return False


# -- RPC extraction ---------------------------------------------------------

def _collect_defs(tree) -> dict[str, ast.AST]:
    """Every def in the module by bare name (module level, class
    methods, and defs nested in factory functions) — the helper
    resolution map.  Later defs win; bare names are unique enough in
    the RPC modules."""
    defs: dict[str, ast.AST] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, node)
    return defs


def _handler_map(tree) -> dict[str, str]:
    """method name -> handler func bare name, from dispatch dict
    literals with ``*_v<N>`` string keys."""
    out = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Dict):
            continue
        for k, v in zip(node.keys, node.values):
            if isinstance(k, ast.Constant) and isinstance(k.value, str) \
                    and "_v" in k.value and k.value.rsplit("_v", 1)[-1] \
                    .isdigit() and isinstance(v, ast.Name):
                out[k.value] = v.id
    return out


def _reader_param(func) -> str | None:
    args = [a.arg for a in func.args.args if a.arg not in ("self", "cls")]
    return args[0] if args else None


def extract_rpc(srcs: dict[str, str]) -> dict:
    """{"method": {"request": [...], "response": [...],
    "client_request": [...]}} across RPC_MODULES."""
    schemas: dict[str, dict] = {}
    client_cands: dict[str, list[list[dict]]] = {}
    for rel in RPC_MODULES:
        tree = ast.parse(srcs[rel], filename=rel)
        helpers = _collect_defs(tree)
        for method, hname in _handler_map(tree).items():
            h = helpers.get(hname)
            if h is None:
                continue
            rd = _OpScanner(helpers, "read")
            reader = _reader_param(h)
            if reader:
                rd.scan_function(h, reader)
            wr = _OpScanner(helpers, "write")
            wr.scan_function(h, None)
            schemas[method] = {"request": rd.fields,
                               "response": wr.fields}
        # client request builders: any def invoking .call("m", ...)
        for func in (n for n in ast.walk(tree)
                     if isinstance(n, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))):
            methods = set()
            for n in ast.walk(func):
                if isinstance(n, ast.Call) and \
                        isinstance(n.func, ast.Attribute) and \
                        n.func.attr in ("call", "call_stream") and \
                        n.args and isinstance(n.args[0], ast.Constant) \
                        and isinstance(n.args[0].value, str):
                    methods.add(n.args[0].value)
            if not methods:
                continue
            wr = _OpScanner(helpers, "write")
            wr.scan_function(func, None)
            if wr.fields:
                for m in methods:
                    client_cands.setdefault(m, []).append(wr.fields)
    for m, cands in client_cands.items():
        if m in schemas:
            # the real builder is the candidate with the most fields
            # (fallback shims re-invoke with fewer)
            schemas[m]["client_request"] = max(cands, key=len)
    return schemas


# -- persisted-format extraction --------------------------------------------

def _last_name(func) -> str | None:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _scope_funcs(tree, only):
    if not only:
        yield tree
        return
    for n in ast.walk(tree):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                n.name in only:
            yield n


def _extract_json_format(spec, trees) -> dict:
    writer_keys: list[str] = []
    for rel, callee, argidx in spec.get("write_dict_args", ()):
        for scope in _scope_funcs(trees[rel], spec.get("only_funcs")):
            for n in ast.walk(scope):
                if isinstance(n, ast.Call) and \
                        _last_name(n.func) == callee and \
                        len(n.args) > argidx and \
                        isinstance(n.args[argidx], ast.Dict):
                    for k in n.args[argidx].keys:
                        if isinstance(k, ast.Constant) and \
                                isinstance(k.value, str) and \
                                k.value not in writer_keys:
                            writer_keys.append(k.value)
    for rel, fname, param in spec.get("write_key_assigns", ()):
        for n in ast.walk(trees[rel]):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and n.name == fname:
                for a in ast.walk(n):
                    if isinstance(a, ast.Assign) and \
                            isinstance(a.targets[0], ast.Subscript) and \
                            isinstance(a.targets[0].value, ast.Name) and \
                            a.targets[0].value.id == param and \
                            isinstance(a.targets[0].slice, ast.Constant):
                        k = a.targets[0].slice.value
                        if isinstance(k, str) and k not in writer_keys:
                            writer_keys.append(k)
    # write_dict_assigns: a format dict BUILT as a named local —
    # ``var = {...}`` literal init plus every ``var["k"] = ...`` widening
    # — inside the named function (health_v1 reports and incident
    # records are assembled this way rather than passed as a literal to
    # one call).
    for rel, fname, var in spec.get("write_dict_assigns", ()):
        for n in ast.walk(trees[rel]):
            if not (isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and n.name == fname):
                continue
            for a in ast.walk(n):
                if not isinstance(a, ast.Assign):
                    continue
                t = a.targets[0]
                if isinstance(t, ast.Name) and t.id == var and \
                        isinstance(a.value, ast.Dict):
                    for k in a.value.keys:
                        if isinstance(k, ast.Constant) and \
                                isinstance(k.value, str) and \
                                k.value not in writer_keys:
                            writer_keys.append(k.value)
                elif isinstance(t, ast.Subscript) and \
                        isinstance(t.value, ast.Name) and \
                        t.value.id == var and \
                        isinstance(t.slice, ast.Constant) and \
                        isinstance(t.slice.value, str) and \
                        t.slice.value not in writer_keys:
                    writer_keys.append(t.slice.value)

    required: set[str] = set()
    tolerated: set[str] = set()
    for rel, calls in spec.get("read_seed_calls", {}).items():
        for scope in _scope_funcs(trees[rel], spec.get("only_funcs")):
            _key_reads(scope, calls,
                       spec.get("read_seed_params", {}).get(rel, ()),
                       required, tolerated)
    for rel, params in spec.get("read_seed_params", {}).items():
        if rel not in spec.get("read_seed_calls", {}):
            _key_reads(trees[rel], (), params, required, tolerated)
    tolerated -= required
    out = {"writer_keys": writer_keys,
           "reader_required": sorted(required),
           "reader_tolerated": sorted(tolerated)}
    if spec.get("external_readers"):
        # the blob's primary consumers live outside the repo
        # (dashboards, operators): recorded in the lockfile so the
        # relaxed dead-writer-key pairing is visible in the contract
        out["external_readers"] = True
    return out


def _key_reads(scope, seed_calls, seed_params, required, tolerated):
    """Collect d["k"] / d.get("k") accesses where d is seeded from a
    configured loader call or parameter name.  A required read under a
    ``try`` that catches KeyError counts as tolerated (torn/absent file
    accepted)."""
    def seeded_names(func):
        names = {p for p in seed_params}
        for n in ast.walk(func):
            if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call) \
                    and _last_name(n.value.func) in seed_calls:
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
                    elif isinstance(t, ast.Attribute):
                        names.add(t.attr)
        return names

    def guarded_by_keyerror(path) -> bool:
        return any(isinstance(p, ast.Try) and any(
            h.type is not None and "KeyError" in ast.dump(h.type)
            for h in p.handlers) for p in path)

    def walk(node, path, names):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names = names | seeded_names(node)
            fparams = {a.arg for a in node.args.args}
            names |= (fparams & set(seed_params))
        is_seed_root = lambda v: (
            (isinstance(v, ast.Name) and v.id in names) or
            (isinstance(v, ast.Attribute) and v.attr in names) or
            (isinstance(v, ast.Call) and _last_name(v.func) in seed_calls) or
            # the ``(rep or {}).get("k")`` none-tolerant idiom
            (isinstance(v, ast.BoolOp) and
             any(is_seed_root(x) for x in v.values)))
        if isinstance(node, ast.Subscript) and \
                isinstance(node.ctx, ast.Load) and \
                is_seed_root(node.value) and \
                isinstance(node.slice, ast.Constant) and \
                isinstance(node.slice.value, str):
            (tolerated if guarded_by_keyerror(path) else
             required).add(node.slice.value)
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "get" and node.args and \
                is_seed_root(node.func.value) and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            tolerated.add(node.args[0].value)
        for child in ast.iter_child_nodes(node):
            walk(child, path + [node], names)

    walk(scope, [], set(seed_params))


def _extract_varint_format(spec, trees) -> dict:
    tree = trees[spec["module"]]
    record: list[str] = []
    tolerant = False
    for n in ast.walk(tree):
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if n.name == spec["writer_func"]:
            # f.write(marshal_varuint64(len(r)) + r): varuint length
            # prefix concatenated with the payload bytes
            for c in ast.walk(n):
                if isinstance(c, ast.BinOp) and isinstance(c.op, ast.Add) \
                        and isinstance(c.left, ast.Call) and \
                        _last_name(c.left.func) == "marshal_varuint64":
                    record = ["varuint64", "bytes"]
        elif n.name == spec["reader_func"]:
            has_unmarshal = any(
                isinstance(c, ast.Call) and
                _last_name(c.func) == "unmarshal_varuint64"
                for c in ast.walk(n))
            # torn-tail tolerance: a bounds guard that breaks out, or a
            # ValueError/IndexError handler around the record loop
            has_guard = any(
                isinstance(c, ast.If) and c.body and
                isinstance(c.body[0], ast.Break)
                for c in ast.walk(n)) or any(
                isinstance(h, ast.ExceptHandler) and h.type is not None
                and "ValueError" in ast.dump(h.type)
                for c in ast.walk(n) if isinstance(c, ast.Try)
                for h in c.handlers)
            tolerant = has_unmarshal and has_guard
    return {"record": record, "reader_tolerates_torn_tail": tolerant}


def _extract_formats(srcs: dict[str, str]) -> dict:
    trees = {rel: ast.parse(src, filename=rel)
             for rel, src in srcs.items()}
    out = {}
    for name, spec in FORMATS.items():
        if spec["kind"] == "json":
            out[name] = dict(kind="json", **_extract_json_format(spec,
                                                                 trees))
        else:
            out[name] = dict(kind="varint_records",
                             **_extract_varint_format(spec, trees))
    return out


def extract_all(sources=None) -> dict:
    srcs = _load_sources(sources)
    return {"version": 1,
            "rpc": extract_rpc(srcs),
            "formats": _extract_formats(srcs)}


# -- checks -----------------------------------------------------------------

def _pairing_problems(schema: dict) -> list[str]:
    """Lockfile-independent writer-vs-reader consistency."""
    out = []
    for method, entry in sorted(schema["rpc"].items()):
        cw = entry.get("client_request")
        sr = entry.get("request")
        if not cw or sr is None:
            continue
        n = min(len(cw), len(sr))
        for i in range(n):
            if cw[i]["op"] != sr[i]["op"] or \
                    cw[i].get("repeat", False) != sr[i].get("repeat",
                                                            False):
                out.append(
                    f"{method}: client writes field {i} as "
                    f"{cw[i]['op']}{'[]' if cw[i].get('repeat') else ''} "
                    f"but the server reads "
                    f"{sr[i]['op']}"
                    f"{'[]' if sr[i].get('repeat') else ''}")
                break
        else:
            if len(cw) > len(sr):
                out.append(
                    f"{method}: client writes {len(cw) - len(sr)} "
                    f"trailing field(s) the server handler never "
                    f"consumes (fields {n}..{len(cw) - 1})")
            elif len(sr) > len(cw):
                for f in sr[n:]:
                    if not f.get("optional"):
                        out.append(
                            f"{method}: server requires field "
                            f"{sr.index(f)} ({f['op']}) that the client "
                            f"never writes")
    for name, entry in sorted(schema["formats"].items()):
        if entry.get("kind") != "json":
            continue
        missing = [k for k in entry["reader_required"]
                   if k not in entry["writer_keys"]]
        if missing:
            out.append(f"{name}: reader requires key(s) "
                       f"{missing} the writer never writes")
        dead = [k for k in entry["writer_keys"]
                if k not in entry["reader_required"] and
                k not in entry["reader_tolerated"]]
        if dead and not entry.get("external_readers"):
            out.append(f"{name}: writer key(s) {dead} no reader ever "
                       f"consumes")
    return out


def _diff_fields(where, lock, cur, breaking, additive):
    n = min(len(lock), len(cur))
    for i in range(n):
        lf, cf = lock[i], cur[i]
        if lf["op"] != cf["op"]:
            breaking.append(f"{where}: field {i} changed "
                            f"{lf['op']} -> {cf['op']} (reorder/retype)")
            return
        if lf.get("repeat", False) != cf.get("repeat", False):
            breaking.append(f"{where}: field {i} ({lf['op']}) repeat "
                            f"grouping changed")
            return
        if lf.get("optional") and not cf.get("optional"):
            breaking.append(
                f"{where}: field {i} ({lf['op']}) lost its trailing "
                f"tolerance (optional -> required strands old peers)")
        elif not lf.get("optional") and cf.get("optional"):
            additive.append(f"{where}: field {i} ({lf['op']}) became "
                            f"optional")
    if len(cur) < len(lock):
        breaking.append(f"{where}: field(s) {len(cur)}..{len(lock) - 1} "
                        f"removed")
    elif len(cur) > len(lock):
        for i in range(n, len(cur)):
            if cur[i].get("optional"):
                additive.append(f"{where}: new optional trailing field "
                                f"{i} ({cur[i]['op']})")
            else:
                breaking.append(
                    f"{where}: new REQUIRED trailing field {i} "
                    f"({cur[i]['op']}) — old peers don't send/expect it")


def diff_schema(lock: dict, cur: dict) -> tuple[list[str], list[str]]:
    """(breaking, additive) messages for cur vs the committed lock."""
    breaking: list[str] = []
    additive: list[str] = []
    for method in sorted(set(lock.get("rpc", {})) | set(cur["rpc"])):
        le, ce = lock.get("rpc", {}).get(method), cur["rpc"].get(method)
        if le is None:
            additive.append(f"{method}: new RPC method")
            continue
        if ce is None:
            breaking.append(f"{method}: RPC method removed")
            continue
        for part in ("request", "response", "client_request"):
            lf, cf = le.get(part), ce.get(part)
            if lf is None and cf is not None:
                additive.append(f"{method}.{part}: newly extracted")
            elif lf is not None and cf is None:
                breaking.append(f"{method}.{part}: no longer extracted")
            elif lf is not None:
                _diff_fields(f"{method}.{part}", lf, cf, breaking,
                             additive)
    for name in sorted(set(lock.get("formats", {})) | set(cur["formats"])):
        lf = lock.get("formats", {}).get(name)
        cf = cur["formats"].get(name)
        if lf is None:
            additive.append(f"format {name}: new")
            continue
        if cf is None:
            breaking.append(f"format {name}: removed")
            continue
        if lf.get("kind") == "json":
            for k in lf["writer_keys"]:
                if k not in cf["writer_keys"]:
                    breaking.append(f"format {name}: writer key {k!r} "
                                    f"removed (old files carry it, old "
                                    f"readers may require it)")
            for k in cf["writer_keys"]:
                if k not in lf["writer_keys"]:
                    additive.append(f"format {name}: new writer key {k!r}")
            for k in cf["reader_required"]:
                if k not in lf["reader_required"]:
                    breaking.append(
                        f"format {name}: reader now REQUIRES key {k!r} "
                        f"(files written before it existed fail to load)")
            for k in lf["reader_required"]:
                if k not in cf["reader_required"] and \
                        k in cf["reader_tolerated"]:
                    additive.append(f"format {name}: key {k!r} became "
                                    f"tolerated")
        else:
            if lf["record"] != cf["record"]:
                breaking.append(f"format {name}: record layout changed "
                                f"{lf['record']} -> {cf['record']}")
            if lf["reader_tolerates_torn_tail"] and \
                    not cf["reader_tolerates_torn_tail"]:
                breaking.append(f"format {name}: torn-tail tolerance "
                                f"dropped (a crashed append would brick "
                                f"the load)")
    return breaking, additive


def check(sources=None, lockfile=None):
    """(exit_code, messages, current_schema)."""
    cur = extract_all(sources)
    msgs = []
    pairing = _pairing_problems(cur)
    if pairing:
        return EXIT_BREAKING, [f"PAIRING: {m}" for m in pairing], cur
    lockfile = lockfile or LOCKFILE
    if not os.path.exists(lockfile):
        return EXIT_ADDITIVE, [
            f"no lockfile at {normalize_path(lockfile)}; generate with "
            f"--update-schema"], cur
    with open(lockfile, encoding="utf-8") as fh:
        lock = json.load(fh)
    breaking, additive = diff_schema(lock, cur)
    if breaking:
        msgs = [f"BREAKING: {m}" for m in breaking] + \
               [f"additive: {m}" for m in additive]
        return EXIT_BREAKING, msgs, cur
    if additive:
        return EXIT_ADDITIVE, [f"additive: {m}" for m in additive], cur
    return EXIT_OK, [], cur


def write_lockfile(schema: dict, lockfile=None) -> None:
    lockfile = lockfile or LOCKFILE
    with open(lockfile, "w", encoding="utf-8") as fh:
        json.dump(schema, fh, indent=1, sort_keys=True)
        fh.write("\n")


# -- CLI --------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m victoriametrics_tpu_torch.devtools.wireschema",
        description="Wire/format schema ratchet: extracted marshal/"
                    "unmarshal schemas vs wire_schema.lock.json.")
    ap.add_argument("--update-schema", action="store_true",
                    help="regenerate the lockfile (additive changes "
                         "only, unless --allow-breaking)")
    ap.add_argument("--allow-breaking", action="store_true",
                    help="with --update-schema: accept a compatibility "
                         "break (spell out the rollout plan in the PR)")
    ap.add_argument("--print", dest="print_", action="store_true",
                    help="dump the extracted schema json")
    ap.add_argument("--lockfile", default=None)
    args = ap.parse_args(argv)

    if args.print_:
        print(json.dumps(extract_all(), indent=1, sort_keys=True))
        return 0

    code, msgs, cur = check(lockfile=args.lockfile)
    if args.update_schema:
        if code == EXIT_BREAKING and not args.allow_breaking:
            for m in msgs:
                print(m, file=sys.stderr)
            print("\nrefusing to lock in a BREAKING schema change; "
                  "re-run with --allow-breaking if the compatibility "
                  "break is intentional", file=sys.stderr)
            return EXIT_BREAKING
        write_lockfile(cur, args.lockfile)
        n = len(cur["rpc"])
        print(f"schema lockfile updated: {n} RPC methods, "
              f"{len(cur['formats'])} persisted formats")
        return 0

    for m in msgs:
        print(m, file=sys.stderr)
    if code == EXIT_BREAKING:
        print(f"\nWIRE SCHEMA BREAK (exit {EXIT_BREAKING}): old peers or "
              f"old files would misparse. Revert, or make the change "
              f"additive-trailing with Reader tolerance.",
              file=sys.stderr)
    elif code == EXIT_ADDITIVE:
        print(f"\nschema drifted (additively). Regenerate the lockfile: "
              f"python -m victoriametrics_tpu_torch.devtools.wireschema "
              f"--update-schema", file=sys.stderr)
    else:
        print(f"wire schema OK: {len(cur['rpc'])} RPC methods, "
              f"{len(cur['formats'])} formats match the lockfile")
    return code


if __name__ == "__main__":
    sys.exit(main())
