"""The port's SARIF emitter (``victoriametrics_tpu_torch/devtools/sarif.py``)
against the reference's: the cases of ``tests/test_sarif.py``, each
written once and run on both packages through the ``P`` fixture (``ref``
= the JAX package, ``port`` = the PyTorch one), every log validated
against that package's vendored SARIF 2.1.0 schema.  The two emitters
give the same log for the same findings, the two schemas are one file,
and the port's lint emits a valid log for its own VMT006 findings."""

import importlib
import json
import os
import types

import jsonschema
import pytest


def _package(name: str):
    root = "victoriametrics_tpu" if name == "ref" else \
        "victoriametrics_tpu_torch"

    def mod(rel):
        return importlib.import_module(f"{root}.devtools.{rel}")
    sarif = mod("sarif")
    schema_path = os.path.join(os.path.dirname(os.path.abspath(
        sarif.__file__)), "sarif_schema_2.1.0.json")
    with open(schema_path, encoding="utf-8") as fh:
        schema = json.load(fh)
    lint = mod("lint")
    return types.SimpleNamespace(
        name=name, root=root, sarif=sarif, lint=lint,
        errorflow=mod("errorflow"), Finding=lint.Finding,
        schema_path=schema_path, schema=schema)


REF, PORT = _package("ref"), _package("port")


@pytest.fixture(params=["ref", "port"])
def P(request):
    return REF if request.param == "ref" else PORT


def _validate(log, schema):
    jsonschema.validate(log, schema,
                        format_checker=jsonschema.FormatChecker())


def _findings(P):
    return [
        P.Finding(f"{P.root}/query/engine.py", 42, "VMT015",
                  "field x has no consistent guard"),
        P.Finding(f"{P.root}/parallel/rpc.py", 7, "VMT016",
                  "AppError escapes to the rpc boundary"),
        P.Finding(f"{P.root}/utils/fs.py", 0, "VMT001",
                  "zero line anchors clamp to 1"),
    ]


def test_empty_log_validates(P):
    log = P.sarif.to_sarif([])
    _validate(log, P.schema)
    assert log["version"] == "2.1.0"
    assert log["runs"][0]["results"] == []
    assert log["runs"][0]["tool"]["driver"]["name"] == "vmt-lint"


def test_findings_log_validates_with_rule_catalog(P):
    log = P.sarif.to_sarif(_findings(P),
                           {"VMT015": "lockset inference",
                            "VMT016": "exception-escape audit"})
    _validate(log, P.schema)
    run = log["runs"][0]
    rules = run["tool"]["driver"]["rules"]
    rule_ids = [r["id"] for r in rules]
    for res in run["results"]:
        assert rule_ids[res["ruleIndex"]] == res["ruleId"]
        assert res["level"] == "error"
        region = res["locations"][0]["physicalLocation"]["region"]
        assert region["startLine"] >= 1
        art = res["locations"][0]["physicalLocation"]["artifactLocation"]
        assert art["uriBaseId"] == "SRCROOT"
    by_id = {r["id"]: r for r in rules}
    assert by_id["VMT015"]["shortDescription"]["text"] == \
        "lockset inference"


def test_mutated_log_fails_validation(P):
    log = P.sarif.to_sarif([P.Finding("a.py", 1, "VMT001", "m")])
    log["version"] = "9.9.9"
    with pytest.raises(jsonschema.ValidationError):
        _validate(log, P.schema)
    log = P.sarif.to_sarif([P.Finding("a.py", 1, "VMT001", "m")])
    del log["runs"][0]["results"][0]["message"]
    with pytest.raises(jsonschema.ValidationError):
        _validate(log, P.schema)


def test_lint_cli_sarif_output_validates(P, capsys):
    rc = P.lint.main(["--format=sarif", "--no-program-passes",
                      f"{P.root}/devtools/sarif.py"])
    log = json.loads(capsys.readouterr().out)
    _validate(log, P.schema)
    assert rc == 0
    assert log["runs"][0]["results"] == []


def test_errorflow_cli_sarif_output_validates(P, capsys):
    rc = P.errorflow.main(["--format=sarif", f"{P.root}/devtools/sarif.py"])
    log = json.loads(capsys.readouterr().out)
    _validate(log, P.schema)
    assert rc == 0


def test_same_findings_give_the_same_log():
    summaries = {"VMT015": "lockset inference"}
    findings = _findings(REF)
    port_findings = [PORT.Finding(f.path, f.line, f.rule, f.message)
                     for f in findings]
    assert PORT.sarif.to_sarif(port_findings, summaries) == \
        REF.sarif.to_sarif(findings, summaries)


def test_schema_files_equal_byte_for_byte():
    with open(REF.schema_path, "rb") as a, open(PORT.schema_path, "rb") as b:
        assert a.read() == b.read()


def test_port_vmt006_findings_emit_a_valid_log(tmp_path, capsys):
    """A kernel wrapper with a host sync, through the port's lint CLI:
    exit 1, one VMT006 result carrying the rule's catalog row."""
    mod = tmp_path / "wrap.py"
    mod.write_text("from .. import kernels\n\n\n"
                   "def scan(n):\n"
                   "    h = kernels.lib('rollup')\n"
                   "    kernels.check(h, h.vm_scan(n.data_ptr()), 'scan')\n"
                   "    return int(n.item())\n", encoding="utf-8")
    rc = PORT.lint.main(["--format=sarif", "--no-baseline", str(mod)])
    log = json.loads(capsys.readouterr().out)
    _validate(log, PORT.schema)
    assert rc == 1
    (res,) = log["runs"][0]["results"]
    assert res["ruleId"] == "VMT006"
    assert res["locations"][0]["physicalLocation"]["region"][
        "startLine"] == 7
    rules = {r["id"]: r for r in log["runs"][0]["tool"]["driver"]["rules"]}
    assert "kernel wrapper" in rules["VMT006"]["shortDescription"]["text"]
