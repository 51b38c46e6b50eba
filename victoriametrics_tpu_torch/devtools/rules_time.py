"""VMT001 — deterministic-time discipline.

Hot paths must read the clock through ``utils/fasttime`` (cached, and
the single seam fake-clock tests patch); direct ``time.time()`` /
``datetime.now()`` calls anywhere else defeat both.  The reference repo
gets this for free by funnelling everything through ``lib/fasttime``.

The port's copy of ``victoriametrics_tpu/devtools/rules_time.py``,
whole.
"""

from __future__ import annotations

import ast

from .lint import dotted_name

# the one module allowed to touch the wall clock
_ALLOWED_SUFFIXES = ("utils/fasttime.py",)

_WALL_CLOCK_CALLS = {
    "time.time", "time.time_ns", "_time.time", "_time.time_ns",
    "datetime.now", "datetime.utcnow",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "dt.now", "dt.utcnow", "dt.datetime.now", "dt.datetime.utcnow",
}


class WallClockRule:
    rule_id = "VMT001"
    summary = ("direct time.time()/datetime.now() outside utils/fasttime "
               "(use fasttime.unix_timestamp()/unix_ms())")

    def check(self, ctx):
        if ctx.rel_path.endswith(_ALLOWED_SUFFIXES):
            return
        for node in ast.walk(ctx.tree):
            # `from time import time` would make every later wall-clock
            # read an undetectable bare `time()` call — flag the import
            if isinstance(node, ast.ImportFrom):
                if node.module == "time":
                    for alias in node.names:
                        if alias.name in ("time", "time_ns"):
                            yield ctx.finding(
                                node, self.rule_id,
                                f"'from time import {alias.name}' hides "
                                f"wall-clock reads from this rule; import "
                                f"the module (or better, use "
                                f"utils.fasttime)")
                continue
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if name in _WALL_CLOCK_CALLS:
                yield ctx.finding(
                    node, self.rule_id,
                    f"direct wall-clock read {name}(); route through "
                    f"utils.fasttime (unix_timestamp is cached; unix_ms/"
                    f"unix_seconds share the seam) so fake-clock tests "
                    f"patch one point")


RULES = [WallClockRule()]
