"""VMT007 — self-observability discipline.

Ad-hoc instance-attribute counters (``self.<name>_total += 1``,
``self.request_count += 1``, ``self.errors += 1``) are invisible to
``/metrics`` unless someone remembers to splice them into an exposition
dict by hand, and they race under threads unless each site grows its own
lock.  The central registry (``utils/metrics.py``) gives every counter a
name, a lock, and automatic exposition — new counting code must go
through it.  Existing sites are grandfathered via the lint baseline.

The port's copy of ``victoriametrics_tpu/devtools/rules_metrics.py``,
whole.
"""

from __future__ import annotations

import ast

# the registry implementation itself is the one place allowed to count
# by attribute mutation
_ALLOWED_SUFFIXES = ("utils/metrics.py",)

# attribute names that mark a counter: the reference's *_total /*_count
# naming, plus the bare counter words this codebase has used
_COUNTER_SUFFIXES = ("_total", "_count")
_COUNTER_NAMES = {"hits", "misses", "errors", "pushes", "reroutes",
                  "rejected", "retries"}


class AdHocCounterRule:
    rule_id = "VMT007"
    summary = ("ad-hoc 'self.<x>_total += 1'-style counter outside "
               "utils/metrics.py (use REGISTRY.counter(...).inc())")

    def check(self, ctx):
        if ctx.rel_path.endswith(_ALLOWED_SUFFIXES):
            return
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.AugAssign)
                    and isinstance(node.op, ast.Add)
                    and isinstance(node.target, ast.Attribute)):
                continue
            attr = node.target.attr
            if not (attr.endswith(_COUNTER_SUFFIXES)
                    or attr in _COUNTER_NAMES):
                continue
            yield ctx.finding(
                node, self.rule_id,
                f"ad-hoc counter '.{attr} +=' is invisible to /metrics "
                f"and unsynchronized; use utils.metrics REGISTRY."
                f"counter(...).inc() (or keep the attribute AND mirror it "
                f"into the registry)")


RULES = [AdHocCounterRule()]
