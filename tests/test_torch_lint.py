"""The port's lint engine (``victoriametrics_tpu_torch/devtools/lint.py``)
against the reference's (``victoriametrics_tpu/devtools/lint.py``): the
fixtures of ``tests/test_lint.py`` through both engines, each case written
once and run on both packages through the ``pkg`` fixture (``ref`` = the
JAX package, ``port`` = the PyTorch one), with the same findings at the
same lines for every rule both engines share (VMT001-005, VMT007-014).

VMT006 differs by design: the reference's rule flags host syncs inside
``jax.jit`` functions, the port's (``devtools/rules_torch.py``) host syncs
inside the CUDA kernel wrappers, with fixtures of its own here.  The port
package is clean against its own (empty) baseline; without their inline
disables, VMT006 reports exactly the two known syncs, ``_scan_rows``'
``n_irregular.item()`` and ``rollup_time_shards``' ``.item()``."""

import os
import re
import types

import pytest

from test_lint import FIXTURES


def _package(name: str):
    if name == "ref":
        from victoriametrics_tpu.devtools import lint
        root = "victoriametrics_tpu"
    else:
        from victoriametrics_tpu_torch.devtools import lint
        root = "victoriametrics_tpu_torch"
    return types.SimpleNamespace(
        name=name, lint=lint, root=root,
        pkg_dir=os.path.join(lint.REPO_ROOT, root))


REF, PORT = _package("ref"), _package("port")


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    return REF if request.param == "ref" else PORT


SHARED = sorted(r for r in FIXTURES if r != "VMT006")


def _cells(findings, drop=("VMT006",)):
    return [(f.line, f.rule, f.message) for f in findings
            if f.rule not in drop]


# -- the reference's fixtures through both engines ---------------------------

@pytest.mark.parametrize("rule", SHARED)
def test_rule_fires_on_bad_fixture(pkg, rule):
    bad, _ = FIXTURES[rule]
    found = {f.rule for f in pkg.lint.lint_source(bad, f"fixture_{rule}_bad.py")}
    assert rule in found, f"{rule} did not fire on its bad fixture"


@pytest.mark.parametrize("rule", SHARED)
def test_rule_quiet_on_good_fixture(pkg, rule):
    _, good = FIXTURES[rule]
    found = [f for f in pkg.lint.lint_source(good, f"fixture_{rule}_good.py")
             if f.rule == rule]
    assert not found, f"false positives: {[str(f) for f in found]}"


@pytest.mark.parametrize("rule", sorted(FIXTURES))
@pytest.mark.parametrize("which", ["bad", "good"])
def test_fixture_findings_equal_in_both_engines(rule, which):
    """Every finding but VMT006's, line, rule and message, is the
    reference's on each fixture (the VMT006 fixtures included: what the
    other rules say of them must agree)."""
    src = FIXTURES[rule][which == "good"]
    ref = REF.lint.lint_source(src, "fixture.py")
    port = PORT.lint.lint_source(src, "fixture.py")
    assert _cells(port) == _cells(ref)


def test_vmt011_exempts_devtools_and_apps_paths(pkg):
    bad, _ = FIXTURES["VMT011"]
    for rel in (f"{pkg.root}/devtools/sched_helper.py",
                f"{pkg.root}/apps/vmworker.py"):
        found = {f.rule for f in pkg.lint.lint_source(bad, rel)}
        assert "VMT011" not in found, rel


def test_rule_catalogs_equal_but_vmt006():
    def catalog(P):
        rules = {r.rule_id: r.summary for r in P.lint.all_rules()}
        rules.update(P.lint.PROGRAM_RULE_SUMMARIES)
        return rules
    ref, port = catalog(REF), catalog(PORT)
    assert sorted(ref) == sorted(port)
    assert {k: v for k, v in ref.items() if k != "VMT006"} == \
        {k: v for k, v in port.items() if k != "VMT006"}
    assert "kernel wrapper" in port["VMT006"]


# -- VMT006 on the kernel wrappers (the port's own fixtures) -----------------

_WRAPPER = """\
import torch
from .. import kernels


def scan(ts, out):
    h = kernels.lib("rollup")
    n = torch.zeros((1,), dtype=torch.int32, device=ts.device)
    kernels.check(h, h.vm_scan(ts.data_ptr(), n.data_ptr()), "scan")
    {line}
    return out
"""

TORCH_BAD = {
    "item": "k = int(n.item())",
    "tolist": "k = n.tolist()",
    "cpu": "k = n.cpu()",
    "numpy": "k = n.numpy()",
    "cuda_sync": "torch.cuda.synchronize()",
    "stream_sync": "torch.cuda.current_stream().synchronize()",
    "event_sync": "ev = torch.cuda.Event(); ev.record(); ev.synchronize()",
    "int_method": "k = int(n.sum())",
    "float_torch": "k = float(torch.max(n))",
    "bool_method": "k = bool(n.any())",
}

TORCH_GOOD = {
    "shape": "k = int(ts.size(0)) + int(ts.shape[1]) + ts.dim()",
    "pointer": "k = int(n.data_ptr()) + n.numel()",
    "host_scalars": "k = int(out is None) + float(len(out))",
    "module_call": "k = int(kernels.sm_count(ts.device))",
    "nested_def": "def later():\n        return n.item()",
}


@pytest.mark.parametrize("case", sorted(TORCH_BAD))
def test_vmt006_flags_host_sync_in_wrapper(case):
    src = _WRAPPER.format(line=TORCH_BAD[case])
    found = [f for f in PORT.lint.lint_source(src, "wrap.py")
             if f.rule == "VMT006"]
    assert [f.line for f in found] == [9], [str(f) for f in found]
    assert "scan()" in found[0].message


@pytest.mark.parametrize("case", sorted(TORCH_GOOD))
def test_vmt006_quiet_on_host_reads(case):
    src = _WRAPPER.format(line=TORCH_GOOD[case])
    found = [str(f) for f in PORT.lint.lint_source(src, "wrap.py")
             if f.rule == "VMT006"]
    assert found == []


def test_vmt006_quiet_outside_a_wrapper():
    """The same value read by the wrapper's caller is the caller's sync,
    not the wrapper's."""
    src = _WRAPPER.format(line="pass") + (
        "\n\ndef caller(ts, out):\n"
        "    n = scan(ts, out)\n"
        "    return int(n.item()), n.cpu(), float(n.sum())\n")
    assert [f for f in PORT.lint.lint_source(src, "wrap.py")
            if f.rule == "VMT006"] == []


def test_vmt006_inline_disable_keeps_a_needed_sync():
    src = _WRAPPER.format(
        line="k = int(n.item())  # vmt: disable=VMT006 — sizes the scratch")
    assert PORT.lint.lint_source(src, "wrap.py") == []


_DISABLE = re.compile(r"\s*# vmt: disable=VMT006\b.*$", re.M)


def test_vmt006_finds_exactly_the_two_known_syncs():
    """With their disables taken out, the rule over the whole port reports
    the two syncs, once each, and nothing else."""
    from victoriametrics_tpu_torch.devtools import rules_torch
    found = []
    for path in PORT.lint.iter_py_files([PORT.pkg_dir]):
        with open(path, encoding="utf-8") as fh:
            src = fh.read()
        found += PORT.lint.lint_source(_DISABLE.sub("", src), path,
                                       rules=rules_torch.RULES)
    assert [(f.path, f.line) for f in found] == [
        ("victoriametrics_tpu_torch/ops/device_rollup.py", 569),
        ("victoriametrics_tpu_torch/parallel/mesh.py", 485)]
    assert "_scan_rows()" in found[0].message
    assert "rollup_time_shards()" in found[1].message


# -- the port's package against its baseline ---------------------------------

def test_package_is_clean_against_checked_in_baseline(pkg):
    findings = pkg.lint.lint_paths([pkg.pkg_dir])
    assert not any(f.rule == "VMT000" for f in findings), "syntax errors?!"
    fresh = pkg.lint.new_findings(
        findings, pkg.lint.load_baseline(pkg.lint.DEFAULT_BASELINE))
    assert fresh == [], "\n".join(str(f) for f in fresh)


def test_port_baseline_grandfathers_nothing():
    assert PORT.lint.load_baseline(PORT.lint.DEFAULT_BASELINE) == {}


def test_port_cli_exits_zero_on_its_tree(capsys):
    """The whole-program run (per-file rules, VMT012-016 and the wire
    schema) over ``victoriametrics_tpu_torch/`` by default."""
    assert PORT.lint.main([]) == 0
    assert capsys.readouterr().out == ""


def test_inline_suppression_silences_only_that_line_and_rule(pkg):
    src = ("import time\n"
           "a = time.time()  # vmt: disable=VMT001\n"
           "b = time.time()\n")
    found = pkg.lint.lint_source(src, "supp.py")
    assert [(f.rule, f.line) for f in found] == [("VMT001", 3)]


def test_baseline_ratchet(pkg, tmp_path):
    L = pkg.lint
    src = "import time\na = time.time()\nb = time.time()\n"
    findings = L.lint_source(src, str(tmp_path / "mod.py"))
    assert len(findings) == 2
    bl = tmp_path / "baseline.txt"
    L.write_baseline(str(bl), findings)
    assert L.new_findings(findings, L.load_baseline(str(bl))) == []
    worse = L.lint_source(src + "c = time.time()\n", str(tmp_path / "mod.py"))
    assert len(L.new_findings(worse, L.load_baseline(str(bl)))) == 3


def test_stale_baseline_entries_fail_with_exit_3(pkg, tmp_path, capsys):
    L = pkg.lint
    mod = tmp_path / "mod.py"
    mod.write_text("import time\na = time.time()\n")
    bl = tmp_path / "baseline.txt"
    L.write_baseline(str(bl), L.lint_paths([str(mod)]))
    assert L.main([str(mod), "--baseline", str(bl)]) == 0
    mod.write_text("import time\na = time.monotonic()\n")
    assert L.main([str(mod), "--baseline", str(bl)]) == 3
    err = capsys.readouterr().err
    assert "BASELINE STALE" in err and "--update-baseline" in err
    mod.write_text("import time\na = time.time()\nb = time.time()\n"
                   "c = eval('1')  # vmt: disable=VMT001\n")
    assert L.main([str(mod), "--baseline", str(bl)]) == 1
    L.write_baseline(str(bl), L.lint_paths([str(mod)]))
    assert L.main([str(mod), "--baseline", str(bl)]) == 0


def test_cli_lists_all_rules(pkg, capsys):
    assert pkg.lint.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rid in sorted(FIXTURES) + ["VMT012", "VMT013", "VMT014", "VMT015",
                                   "VMT016"]:
        assert rid in out


# -- VMT013: stale suppressions ----------------------------------------------

def _ctxs_for(L, tmp_path, src):
    mod = tmp_path / "mod.py"
    mod.write_text(src, encoding="utf-8")
    ctxs: list = []
    findings = L.lint_paths([str(mod)], collect_ctxs=ctxs)
    return findings, ctxs


def test_vmt013_flags_disable_that_silenced_nothing(pkg, tmp_path):
    L = pkg.lint
    findings, ctxs = _ctxs_for(L, tmp_path,
                               "import time\n"
                               "a = time.monotonic()  # vmt: disable=VMT001\n")
    assert findings == []
    stale = L.stale_disable_findings(ctxs)
    assert [(f.rule, f.line) for f in stale] == [(L.STALE_DISABLE_RULE, 2)]
    assert "VMT001" in stale[0].message


def test_vmt013_quiet_when_disable_is_consumed(pkg, tmp_path):
    L = pkg.lint
    findings, ctxs = _ctxs_for(L, tmp_path,
                               "import time\n"
                               "a = time.time()  # vmt: disable=VMT001\n")
    assert findings == []
    assert L.stale_disable_findings(ctxs) == []


def test_vmt013_ignores_disable_text_inside_strings(pkg, tmp_path):
    L = pkg.lint
    findings, ctxs = _ctxs_for(
        L, tmp_path,
        '"""usage: add  # vmt: disable=VMT001  to the line."""\n'
        "import time\n"
        "a = time.time()\n")
    assert [f.rule for f in findings] == ["VMT001"]
    assert L.stale_disable_findings(ctxs) == []


def test_vmt013_judges_only_rules_that_ran(pkg, tmp_path):
    L = pkg.lint
    _findings, ctxs = _ctxs_for(L, tmp_path,
                                "import time\n"
                                "time.sleep(1)  # vmt: disable=VMT012\n")
    ran = {r.rule_id for r in L.all_rules()}
    assert L.stale_disable_findings(ctxs, ran_rules=ran) == []
    rel = ctxs[0].rel_path
    ran_all = ran | {"VMT012"}
    assert L.stale_disable_findings(
        ctxs, extra_used={rel: {(2, "VMT012")}}, ran_rules=ran_all) == []
    stale = L.stale_disable_findings(ctxs, ran_rules=ran_all)
    assert [f.rule for f in stale] == [L.STALE_DISABLE_RULE]


def test_vmt013_on_a_stale_vmt006_disable(tmp_path):
    """The port's own rule takes part in VMT013: a disable left behind
    after the sync went is stale."""
    L = PORT.lint
    src = _WRAPPER.format(line="k = 1  # vmt: disable=VMT006")
    findings, ctxs = _ctxs_for(L, tmp_path, src)
    assert findings == []
    stale = L.stale_disable_findings(ctxs)
    assert [(f.rule, f.line) for f in stale] == [(L.STALE_DISABLE_RULE, 9)]


# -- VMT014: env-flag inventory vs README ------------------------------------

def test_vmt014_fires_on_undocumented_flag(pkg, tmp_path):
    L = pkg.lint
    _findings, ctxs = _ctxs_for(
        L, tmp_path,
        "import os\n"
        'w = os.environ.get("VM_NOT_DOCUMENTED_XYZ", "0")\n')
    flagged = L.env_flag_findings(ctxs)
    assert [f.rule for f in flagged] == [L.ENV_FLAG_RULE]
    assert "VM_NOT_DOCUMENTED_XYZ" in flagged[0].message


def test_vmt014_quiet_on_documented_flag(pkg, tmp_path):
    L = pkg.lint
    _findings, ctxs = _ctxs_for(
        L, tmp_path,
        "import os\n"
        'w = os.environ.get("VM_SEARCH_WORKERS", "0")\n')
    assert L.env_flag_findings(ctxs) == []


def test_package_flag_inventory_is_fully_documented(pkg):
    ctxs: list = []
    pkg.lint.lint_paths([pkg.pkg_dir], rules=[], collect_ctxs=ctxs)
    inv = set(pkg.lint.env_flag_inventory(ctxs))
    assert sorted(inv - pkg.lint.readme_flags()) == []


def test_cli_list_flags_covers_its_package(pkg, capsys):
    """With a path list the inventory is still the whole package's."""
    assert pkg.lint.main(["--list-flags", pkg.lint.__file__]) == 0
    out = capsys.readouterr().out
    assert "VM_SEARCH_WORKERS" in out
    assert f"{pkg.root}/" in out
    other = "victoriametrics_tpu_torch/" if pkg.name == "ref" else \
        "victoriametrics_tpu/"
    assert other not in out


def test_port_walk_skips_the_build_directory(tmp_path):
    """``_build/`` holds the built libraries and checkouts unpacked there
    for a chip run: the port's walk (and the call graph over it) skips
    it."""
    (tmp_path / "_build" / "copy").mkdir(parents=True)
    (tmp_path / "_build" / "copy" / "m.py").write_text("import time\n")
    (tmp_path / "a.py").write_text("import time\n")
    assert [os.path.relpath(p, tmp_path) for p in
            PORT.lint.iter_py_files([str(tmp_path)])] == ["a.py"]
