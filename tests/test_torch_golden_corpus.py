"""The golden conformance corpus (tests/golden_corpus.json, 589 cases
transcribed from the upstream exec_test.go's TestExecSuccess harness)
through the port's ``exec_query``.

Each case runs on the corpus's grid (start 1000 s, end 2000 s, step
200 s, no storage) and must:

  * match its recorded results at the reference test's rtol/atol 2e-9
    (tests/test_golden_corpus.py, which stays as it is);
  * give the same series in the same order with the same values as the
    JAX package's ``exec_query`` on the same grid.  Both evaluate with
    the same numpy code, so the values are held bit for bit (NaN equal to
    NaN)."""

import json
import math
import os

import numpy as np
import pytest

from test_torch_exec import same_rows
from victoriametrics_tpu.query import exec as ref_exec
from victoriametrics_tpu.query import types as ref_types
from victoriametrics_tpu_torch.query import exec as port_exec
from victoriametrics_tpu_torch.query import types as port_types

HERE = os.path.dirname(__file__)
with open(os.path.join(HERE, "golden_corpus.json")) as _f:
    CASES = json.load(_f)
GRID = dict(start=1_000_000, end=2_000_000, step=200_000, storage=None)


def _tovals(vs):
    return [math.nan if v is None else
            (math.inf if v == "inf" else -math.inf) if isinstance(v, str)
            else float(v) for v in vs]


def test_corpus_size():
    assert len(CASES) == 589


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["q"][:60])
def test_golden(case):
    rows = port_exec.exec_query(port_types.EvalConfig(**GRID), case["q"])
    want = case["results"]
    assert len(rows) == len(want), \
        f"{case['q']}: {len(rows)} series, want {len(want)}"
    wmap = {}
    for w in want:
        wmap.setdefault(json.dumps(w["labels"], sort_keys=True),
                        []).append(w)
    for r in rows:
        key = json.dumps(r.metric_name.to_dict(), sort_keys=True)
        lst = wmap.get(key)
        assert lst, f"{case['q']}: unexpected series {key}"
        w = lst.pop(0)
        np.testing.assert_allclose(
            r.values, _tovals(w["values"]), rtol=2e-9, atol=2e-9,
            equal_nan=True, err_msg=case["q"])
    same_rows(rows, ref_exec.exec_query(ref_types.EvalConfig(**GRID),
                                        case["q"]), case["q"])
