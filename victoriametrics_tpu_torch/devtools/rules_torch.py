"""VMT006 — host syncs inside the port's kernel wrappers.

Takes the place of the reference's ``devtools/rules_jax.py`` (host syncs
inside ``jax.jit`` functions): the port has no traced functions, but its
kernel wrappers play their part.  A kernel wrapper is a function whose
own body (nested functions excluded) calls ``kernels.lib(...)`` or
``kernels.check(...)``; it enqueues its launches on the device's stream
and returns.  A device->host read inside one stalls the host until the
stream drains, serializes the launches the caller meant to overlap, and
keeps the wrapper out of a CUDA graph.  Flagged inside a wrapper:

- ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``;
- ``torch.cuda.synchronize()`` and ``<stream or event>.synchronize()``;
- ``int(...)``, ``float(...)``, ``bool(...)`` applied directly to a
  method call on a tensor (``int(t.sum())``) or to a ``torch.*`` call,
  which read the value back the same way.  Shape and pointer reads
  (``t.size(0)``, ``t.data_ptr()``, ...) stay on the host and pass.

A sync that a wrapper needs (a count that sizes the next launch's
scratch) is kept with ``# vmt: disable=VMT006`` and its reason on the
line.
"""

from __future__ import annotations

import ast

from .lint import dotted_name

_WRAPPER_CALLS = {"kernels.lib", "kernels.check"}
_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy", "synchronize"}
_CASTS = {"int", "float", "bool"}
# tensor methods that read host-side metadata, never the device's values
_METADATA_ATTRS = {"size", "dim", "numel", "nelement", "stride",
                   "data_ptr", "element_size", "storage_offset",
                   "get_device", "is_contiguous", "ndimension"}


def _own_nodes(fn):
    """The nodes of ``fn``'s own body: nested functions, lambdas and
    classes are not walked (their code runs when they are called)."""
    scopes = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
              ast.ClassDef)
    stack = [n for n in fn.body if not isinstance(n, scopes)]
    while stack:
        node = stack.pop()
        yield node
        stack.extend(c for c in ast.iter_child_nodes(node)
                     if not isinstance(c, scopes))


def _imported_names(tree) -> set[str]:
    """Names bound by imports anywhere in the module: a call on one of
    them is a module function, not a tensor method."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                out.add((alias.asname or alias.name).split(".")[0])
    return out


def _reads_tensor(call, modules) -> bool:
    """True when ``call`` (the argument of an int/float/bool cast)
    yields a tensor whose value the cast reads back."""
    func = call.func
    if not isinstance(func, ast.Attribute):
        return False
    name = dotted_name(func) or ""
    if name.startswith("torch."):
        return True
    if func.attr in _METADATA_ATTRS or func.attr in _SYNC_ATTRS:
        return False   # metadata stays on the host; a sync is flagged
    root = name.split(".")[0] if name else None
    return root not in modules


def is_wrapper(fn) -> bool:
    return any(isinstance(n, ast.Call) and
               dotted_name(n.func) in _WRAPPER_CALLS
               for n in _own_nodes(fn))


class TorchHostSyncRule:
    rule_id = "VMT006"
    summary = (".item()/.tolist()/.cpu()/.numpy()/synchronize() or an "
               "int/float/bool read of a tensor inside a kernel wrapper")

    def check(self, ctx):
        modules = None
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not is_wrapper(fn):
                continue
            if modules is None:
                modules = _imported_names(ctx.tree)
            for node in _own_nodes(fn):
                if not isinstance(node, ast.Call):
                    continue
                func = node.func
                if isinstance(func, ast.Attribute) and \
                        func.attr in _SYNC_ATTRS:
                    what = f"{dotted_name(func) or '.' + func.attr}()"
                elif isinstance(func, ast.Name) and func.id in _CASTS and \
                        len(node.args) == 1 and \
                        isinstance(node.args[0], ast.Call) and \
                        _reads_tensor(node.args[0], modules):
                    inner = node.args[0].func
                    what = f"{func.id}({dotted_name(inner) or inner.attr}" \
                           f"(...))"
                else:
                    continue
                yield ctx.finding(
                    node, self.rule_id,
                    f"{what} inside kernel wrapper {fn.name}(): a host "
                    f"sync stalls the host until the stream drains; keep "
                    f"the value on the device, move the read to the "
                    f"caller, or disable it here with its reason")


RULES = [TorchHostSyncRule()]
