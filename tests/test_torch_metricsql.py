"""Port parity for the MetricsQL parser and optimizer
(victoriametrics_tpu_torch/query/metricsql/) against the reference's.

The queries: every query of tests/golden_corpus.json (read, never
changed), every query text that tests/test_metricsql.py parses, and the
pushdown and conformance tables of tests/test_optimizer.py.  For each,
one parametrised test per property:

  * ``str()`` of the parsed expression is the reference's, byte for byte
    (the device plane keys its rolling windows on a selector's text);
  * the ASTs are equal node by node: the same type name and every
    dataclass field equal;
  * the optimizer's output is equal, in text and node by node;
  * a text the reference refuses (test_metricsql.py's bad inputs, and any
    corpus text it cannot parse) raises the port's ``ParseError`` with the
    reference's message.

Every comparison is exact."""

import ast as pyast
import dataclasses
import json
import math
import os

import pytest

import test_metricsql
import test_optimizer
from victoriametrics_tpu.query import exec as ref_exec
from victoriametrics_tpu.query.metricsql import ParseError as RefParseError
from victoriametrics_tpu.query.metricsql import parse as ref_parse
from victoriametrics_tpu.query.metricsql.optimizer import \
    optimize as ref_optimize
from victoriametrics_tpu_torch.query import exec as port_exec
from victoriametrics_tpu_torch.query.metricsql import ParseError, parse
from victoriametrics_tpu_torch.query.metricsql.optimizer import optimize

HERE = os.path.dirname(os.path.abspath(__file__))


def _corpus() -> list[str]:
    with open(os.path.join(HERE, "golden_corpus.json")) as f:
        return [case["q"] for case in json.load(f)]


def _parsed_in(path: str) -> list[str]:
    """The literal texts a test module hands to parse(), and the literal
    lists it loops over and parses."""
    with open(path) as f:
        tree = pyast.parse(f.read())
    out = []
    for node in pyast.walk(tree):
        if isinstance(node, pyast.Call) and \
                getattr(node.func, "id", None) == "parse" and node.args and \
                isinstance(node.args[0], pyast.Constant) and \
                isinstance(node.args[0].value, str):
            out.append(node.args[0].value)
        elif isinstance(node, pyast.For) and \
                isinstance(node.iter, (pyast.List, pyast.Tuple)):
            out.extend(e.value for e in node.iter.elts
                       if isinstance(e, pyast.Constant) and
                       isinstance(e.value, str))
    return out


def _bad_inputs() -> list[str]:
    (mark,) = [m for m in test_metricsql.test_parse_errors.pytestmark
               if m.name == "parametrize"]
    return list(mark.args[1])


def _cases() -> list[tuple[str, str]]:
    """(id, query) for every query, each text once."""
    sources = [("corpus", _corpus()),
               ("metricsql", _parsed_in(test_metricsql.__file__)),
               ("pushdown", [q for q, _ in test_optimizer.PUSHDOWN_TABLE] +
                [want for _, want in test_optimizer.PUSHDOWN_TABLE]),
               ("conformance", list(test_optimizer.CONFORMANCE_QUERIES)),
               ("bad", _bad_inputs())]
    seen, out = set(), []
    for name, qs in sources:
        for i, q in enumerate(qs):
            if q not in seen:
                seen.add(q)
                out.append((f"{name}{i}", q))
    return out


CASES = _cases()
IDS = [i for i, _ in CASES]
QUERIES = [q for _, q in CASES]


def _outcome(parse_fn, err_type, q):
    try:
        return parse_fn(q), None
    except err_type as e:
        return None, str(e)


def _same_node(a, b, path="expr"):
    """Assert two ASTs equal node by node: type name, then every field."""
    assert type(a).__name__ == type(b).__name__, \
        f"{path}: {type(a).__name__} != {type(b).__name__}"
    if dataclasses.is_dataclass(a):
        names = [f.name for f in dataclasses.fields(a)]
        assert names == [f.name for f in dataclasses.fields(b)], path
        for n in names:
            _same_node(getattr(a, n), getattr(b, n), f"{path}.{n}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), f"{path}: {len(a)} != {len(b)} items"
        for i, (x, y) in enumerate(zip(a, b)):
            _same_node(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and math.isnan(a):
        assert math.isnan(b), path
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


def test_the_cases_cover_the_corpus_and_the_reference_tests():
    assert len(_corpus()) == 589
    assert set(_corpus()) <= set(QUERIES)
    assert len(_parsed_in(test_metricsql.__file__)) >= 30
    assert len(_bad_inputs()) == 13


@pytest.mark.parametrize("q", QUERIES, ids=IDS)
def test_text_equals_the_reference(q):
    want, want_err = _outcome(ref_parse, RefParseError, q)
    got, got_err = _outcome(parse, ParseError, q)
    assert got_err == want_err
    if want is not None:
        assert str(got) == str(want)


@pytest.mark.parametrize("q", QUERIES, ids=IDS)
def test_ast_equals_the_reference(q):
    want, want_err = _outcome(ref_parse, RefParseError, q)
    got, got_err = _outcome(parse, ParseError, q)
    assert got_err == want_err
    if want is not None:
        _same_node(got, want)


@pytest.mark.parametrize("q", QUERIES, ids=IDS)
def test_optimizer_equals_the_reference(q):
    want, _ = _outcome(ref_parse, RefParseError, q)
    if want is None:
        with pytest.raises(ParseError):
            parse(q)
        return
    want_opt = ref_optimize(want)
    got_opt = optimize(parse(q))
    assert str(got_opt) == str(want_opt)
    _same_node(got_opt, want_opt)


@pytest.mark.parametrize("bad", _bad_inputs())
def test_parse_error_equals_the_reference(bad):
    with pytest.raises(RefParseError) as want:
        ref_parse(bad)
    with pytest.raises(ParseError) as got:
        parse(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("flag", ["0", "1"])
def test_parse_cached_equals_the_reference(flag, monkeypatch):
    monkeypatch.setenv("VM_MQL_OPTIMIZE", flag)
    for _, q in test_optimizer.PUSHDOWN_TABLE:
        _same_node(port_exec.parse_cached(q), ref_exec.parse_cached(q))
    assert port_exec.optimize_enabled() is (flag == "1")
