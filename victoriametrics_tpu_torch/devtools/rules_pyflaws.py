"""VMT002/VMT003 — classic Python foot-guns.

VMT002: mutable default arguments (one shared object across all calls —
the ``_ovh_get(..., _delta_memo={})`` bug class).
VMT003: bare ``except:`` (catches KeyboardInterrupt/SystemExit) and
silent ``except Exception: pass`` (swallows every error with no trace).
Narrow handlers like ``except ValueError: pass`` are idiomatic control
flow and are left alone.

The port's copy of ``victoriametrics_tpu/devtools/rules_pyflaws.py``,
whole.
"""

from __future__ import annotations

import ast

from .lint import dotted_name

_MUTABLE_CTORS = {"list", "dict", "set", "bytearray", "deque",
                  "defaultdict", "OrderedDict", "Counter"}
_BROAD_EXC = {"Exception", "BaseException"}


def _is_mutable_default(node) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set)):
        return True
    if isinstance(node, ast.Call):
        name = dotted_name(node.func)
        return bool(name) and name.split(".")[-1] in _MUTABLE_CTORS
    return False


class MutableDefaultRule:
    rule_id = "VMT002"
    summary = "mutable default argument (shared across every call)"

    def check(self, ctx):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.Lambda)):
                continue
            a = node.args
            defaults = list(a.defaults) + [d for d in a.kw_defaults if d]
            for d in defaults:
                if _is_mutable_default(d):
                    fn = getattr(node, "name", "<lambda>")
                    yield ctx.finding(
                        d, self.rule_id,
                        f"mutable default argument in {fn}(); the object "
                        f"is created once and shared by every call — use "
                        f"None + in-body init or a module-level cache")


def _handler_names(type_node) -> set[str]:
    nodes = type_node.elts if isinstance(type_node, ast.Tuple) else [type_node]
    out = set()
    for n in nodes:
        name = dotted_name(n)
        if name:
            out.add(name.split(".")[-1])
    return out


def _body_is_silent(body) -> bool:
    for stmt in body:
        if isinstance(stmt, ast.Pass):
            continue
        if isinstance(stmt, ast.Expr) and \
                isinstance(stmt.value, ast.Constant) and \
                stmt.value.value is Ellipsis:
            continue
        return False
    return True


class SilentExceptRule:
    rule_id = "VMT003"
    summary = "bare 'except:' or silent 'except Exception: pass'"

    def check(self, ctx):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                yield ctx.finding(
                    node, self.rule_id,
                    "bare 'except:' also catches KeyboardInterrupt/"
                    "SystemExit; name the exceptions (or 'except "
                    "Exception' + log at a harness boundary)")
            elif _body_is_silent(node.body) and \
                    _handler_names(node.type) & _BROAD_EXC:
                yield ctx.finding(
                    node, self.rule_id,
                    "silent 'except Exception: pass' swallows every error "
                    "with no trace; narrow the type or log it")


RULES = [MutableDefaultRule(), SilentExceptRule()]
