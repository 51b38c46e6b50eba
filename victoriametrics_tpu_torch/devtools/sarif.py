"""SARIF 2.1.0 emission for the lint engine and program passes.

One emitter for everything: VMT001–VMT011 line rules, the wire-schema
ratchet, and the whole-program passes (deadline-taint, lockset,
errorflow) all produce :class:`lint.Finding` rows, so one
``to_sarif()`` turns any of their outputs into a single-run SARIF log
that CI annotators and editors ingest directly.

The output is the minimal *valid* subset of the spec: ``version`` +
``$schema``, one ``run`` with a ``tool.driver`` carrying the rule
catalog, and one ``result`` per finding with ``ruleId``, ``level``,
``message.text`` and a ``physicalLocation`` (repo-relative URI +
1-based ``startLine``).  ``tests/test_sarif.py`` validates it against
the vendored structural subset of the official 2.1.0 schema
(``sarif_schema_2.1.0.json``).

The port's copy of ``victoriametrics_tpu/devtools/sarif.py``, whole.
"""

from __future__ import annotations

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA_URI = ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json")

TOOL_NAME = "vmt-lint"


def to_sarif(findings, rule_summaries: dict[str, str] | None = None,
             tool_name: str = TOOL_NAME) -> dict:
    """Findings -> a SARIF 2.1.0 log dict (caller json.dumps it).

    ``rule_summaries`` maps rule id -> one-line description for the
    driver's rule catalog; rules appearing only in findings get a
    catalog entry with an empty description so every ``ruleId`` in
    ``results`` resolves via ``rules``.
    """
    summaries = dict(rule_summaries or {})
    for f in findings:
        summaries.setdefault(f.rule, "")
    rules = [{"id": rid,
              "shortDescription": {"text": summaries[rid] or rid}}
             for rid in sorted(summaries)]
    index = {r["id"]: i for i, r in enumerate(rules)}
    results = [{
        "ruleId": f.rule,
        "ruleIndex": index[f.rule],
        "level": "error",
        "message": {"text": f.message},
        "locations": [{
            "physicalLocation": {
                "artifactLocation": {"uri": f.path,
                                     "uriBaseId": "SRCROOT"},
                "region": {"startLine": max(int(f.line), 1)},
            },
        }],
    } for f in findings]
    return {
        "$schema": SARIF_SCHEMA_URI,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {"driver": {
                "name": tool_name,
                "informationUri":
                    "https://github.com/VictoriaMetrics/VictoriaMetrics",
                "rules": rules,
            }},
            "columnKind": "utf16CodeUnits",
            "originalUriBaseIds": {"SRCROOT": {"uri": "file:///"}},
            "results": results,
        }],
    }
