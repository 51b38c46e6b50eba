"""The PyTorch/CUDA port imports no JAX, nothing of the JAX package and no
``xxhash`` (the machine with the card has none; the native codec carries
xxh64/xxh32): every module of victoriametrics_tpu_torch, and chip_smoke.py,
load in a process where importing jax, the JAX package or xxhash fails.
The rule-file, scrape-config, vmalert_tool and vmauth paths load JSON
configs where PyYAML is blocked too (the card's machine has no PyYAML).
Importing them builds nothing: no compiler process starts and no file is
written under the package's ``_build/`` (the native codec and the CUDA
kernels build on first use).  The evaluator and the columnar ingest run
there too."""

import os
import pkgutil
import subprocess
import sys

import victoriametrics_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import builtins, importlib, os, runpy, subprocess, sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.modules["jaxlib"] = None
sys.modules["xxhash"] = None
sys.modules["victoriametrics_tpu"] = None   # nor the JAX package
BUILD = os.path.join(os.getcwd(), "victoriametrics_tpu_torch", "_build")
built = []
real_open, real_os_open, real_popen = builtins.open, os.open, subprocess.Popen


def _writes(path, how):
    if os.path.abspath(os.fspath(path)).startswith(BUILD) and how:
        built.append(os.fspath(path))


def _open(file, mode="r", *a, **k):
    if isinstance(file, (str, bytes, os.PathLike)):
        _writes(file, any(c in mode for c in "wax+"))
    return real_open(file, mode, *a, **k)


def _os_open(path, flags, *a, **k):
    _writes(path, flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT))
    return real_os_open(path, flags, *a, **k)


class _Popen(real_popen):
    def __init__(self, args, *a, **k):
        built.append(args)
        super().__init__(args, *a, **k)


builtins.open, os.open, subprocess.Popen = _open, _os_open, _Popen
mods = sys.argv[1:]
for m in mods:
    importlib.import_module(m)
sys.argv = ["chip_smoke.py", "--help"]
try:
    runpy.run_path("chip_smoke.py", run_name="__main__")
except SystemExit as e:
    assert e.code in (0, None), e.code
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("victoriametrics_tpu", "jax", "jaxlib",
                                       "xxhash")
                and sys.modules[m] is not None)
print("LEAKED", leaked)
print("LOADED", len(mods))
print("BUILT", built)
loaded = (sys.modules["victoriametrics_tpu_torch.native"]._tried,
          dict(sys.modules["victoriametrics_tpu_torch.kernels"]._libs))
print("LIBRARIES", loaded)
"""


def _port_modules():
    pkg = victoriametrics_tpu_torch
    names = [pkg.__name__]
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        names.append(info.name)
    return names


def test_port_and_chip_smoke_import_without_jax():
    mods = _port_modules()
    assert "victoriametrics_tpu_torch.query.cuda_engine" in mods
    assert {"victoriametrics_tpu_torch.parallel.mesh",
            "victoriametrics_tpu_torch.parallel.partition",
            "victoriametrics_tpu_torch.native",
            "victoriametrics_tpu_torch.ops.varint",
            "victoriametrics_tpu_torch.ops.nearest_delta",
            "victoriametrics_tpu_torch.ops.compress",
            "victoriametrics_tpu_torch.ops.encoding"} <= set(mods)
    assert {f"victoriametrics_tpu_torch.storage.{m}" for m in (
        "tsid", "metric_name", "tag_filters", "dedup", "block", "part",
        "mergeset", "index_db", "partition", "downsample", "table",
        "columnar", "storage", "cardinality")} <= set(mods)
    assert {f"victoriametrics_tpu_torch.{m}" for m in (
        "query.metricsql", "query.metricsql.ast", "query.metricsql.parser",
        "query.metricsql.optimizer", "ops.rollup_np", "query.rollup_funcs",
        "utils.querytracer", "utils.memory", "utils.costacc", "query.limits",
        "query.types", "query.aggr_funcs", "query.binary_op", "query.gorand",
        "query.transform_funcs", "query.vmhistogram", "query.format_value",
        "query.exec", "query.eval", "query.rollup_result_cache",
        "utils.flightrec", "utils.metrics")} <= set(mods)
    assert {f"victoriametrics_tpu_torch.{m}" for m in (
        "parallel.rpc", "ingest.ratelimiter", "ingest.serieslimits",
        "ingest.protowire", "ingest.snappy", "ingest.parsers",
        "ingest.remote_write", "ingest.otlp", "ingest.relabel",
        "ingest.streamaggr", "ingest.ingestserver",
        "utils.workpool", "utils.profiler", "utils.device_probe",
        "utils.buildinfo", "query.querystats", "query.matstream",
        "httpapi.server", "httpapi.prometheus_api",
        "apps.vmsingle")} <= set(mods)
    assert {f"victoriametrics_tpu_torch.{m}" for m in (
        "ingest.persistentqueue", "ingest.discovery", "apps.vmagent",
        "apps.vmalert", "apps.vmalert_tool", "httpapi.graphite_api",
        "httpapi.graphite_funcs", "utils.configfile")} <= set(mods)
    assert {f"victoriametrics_tpu_torch.{m}" for m in (
        "utils.jwt", "apps.vmauth", "apps.vmbackup", "utils.promtsdb",
        "apps.vmctl")} <= set(mods)
    assert {f"victoriametrics_tpu_torch.devtools.{m}" for m in (
        "lint", "rules_time", "rules_pyflaws", "rules_locks",
        "rules_metrics", "rules_threads", "rules_torch", "callgraph",
        "deadline_taint", "lockset", "errorflow", "wireschema", "sarif",
        "locktrace", "racetrace", "sched", "faultinject",
        "flight_overhead", "profile_overhead", "matstream_overhead",
        "selfscrape_overhead", "downsample_smoke", "reshard_smoke",
        "compile_cache_smoke")} <= set(mods)
    assert len(mods) >= 118
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", PROBE, *mods], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LEAKED []" in out.stdout, out.stdout
    assert f"LOADED {len(mods)}" in out.stdout
    assert "usage: chip_smoke.py" in out.stdout
    assert "BUILT []" in out.stdout, out.stdout
    assert "LIBRARIES (False, {})" in out.stdout, out.stdout


EVAL_PROBE = r"""
import json, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["xxhash"] = None
sys.modules["victoriametrics_tpu"] = None
from victoriametrics_tpu_torch import native
from victoriametrics_tpu_torch.query import eval as ev
from victoriametrics_tpu_torch.query import exec as ex
from victoriametrics_tpu_torch.query import rollup_result_cache as rrc
from victoriametrics_tpu_torch.query.types import EvalConfig
from victoriametrics_tpu_torch.utils import flightrec, metrics

hashed = []
real = native.xxh64
native.xxh64 = lambda data, seed=0: hashed.append(bytes(data)) or \
    real(data, seed)
out = {}
for q in json.loads(sys.argv[1]):
    rows = ex.exec_query(EvalConfig(start=1_000_000, end=2_000_000,
                                    step=200_000), q)
    out[q] = [[bytes(ts.metric_name.marshal()).hex(),
               [None if v != v else v for v in ts.values.tolist()]]
              for ts in rows]
flightrec.instant("probe:done")
cap = flightrec.FlightRecorder(max_captures=1).capture("probe",
                                                       window_s=60.0)
assert any(e["name"] == "probe:done" for e in cap["trace"]["traceEvents"])
h = metrics.REGISTRY.histogram("probe_seconds")
h.update(0.25)
assert h.buckets() and metrics.gc_pause_hooks
assert rrc.GLOBAL.stats()["entries"] == 0
print("HASHED", len(hashed))
print("ROWS", json.dumps(out))
"""

LIMITK = [
    'limitk(1, label_set(10, "foo", "bar") or '
    'label_set(time()/150, "xbaz", "sss"))',
    'sort(limitk(10, label_set(10, "foo", "bar") or '
    'label_set(time()/150, "baz", "sss")))',
]


def test_evaluator_runs_without_jax_and_hashes_natively():
    """The evaluator, executor, result cache, flight recorder and metrics
    run with jax, the JAX package and xxhash blocked: limitk's series
    hash goes through native.xxh64, and the rows equal the JAX package's
    (each row's marshalled name and values)."""
    import json

    import numpy as np

    from victoriametrics_tpu.query.exec import exec_query as ref_exec
    from victoriametrics_tpu.query.types import EvalConfig as RefEC
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", EVAL_PROBE,
                          json.dumps(LIMITK)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines()
                 if line.startswith(("HASHED", "ROWS")))
    assert int(lines["HASHED"]) >= 4  # two series a limitk, two queries
    got = json.loads(lines["ROWS"])
    for q in LIMITK:
        want = ref_exec(RefEC(start=1_000_000, end=2_000_000, step=200_000),
                        q)
        assert [bytes.fromhex(k) for k, _ in got[q]] == \
            [bytes(ts.metric_name.marshal()) for ts in want], q
        for (_, vals), ts in zip(got[q], want):
            np.testing.assert_array_equal(
                np.array([np.nan if v is None else v for v in vals]),
                ts.values)


INGEST_PROBE = r"""
import sys, time
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["xxhash"] = None
sys.modules["victoriametrics_tpu"] = None
from victoriametrics_tpu_torch import native
from victoriametrics_tpu_torch.ingest import remote_write, streamaggr
from victoriametrics_tpu_torch.storage.storage import Storage
from victoriametrics_tpu_torch.storage.tag_filters import filters_from_dict

t0 = int(time.time() * 1000) - 86_400_000
series = [([("__name__", "nj"), ("i", str(i))],
           [(t0 + j * 15_000, float(i + j)) for j in range(5)])
          for i in range(7)]
body = native.snappy_uncompress(remote_write.build_write_request(series))
cr = native.parse_rw_columnar(body, t0)
st = Storage(sys.argv[1])
n = st.add_rows_columnar(cr)
cols = st.search_columns(filters_from_dict({"__name__": "nj"}), t0 - 1,
                         t0 + 86_400_000)
out = []
agg = streamaggr.load_from_text("- interval: 1m\n  outputs: [sum_samples]\n",
                                out.extend)
agg.push({"__name__": "nj"}, t0, 2.0)
agg.stop()
st.close()
print("INGESTED", n, len(cols.raw_names), int(cols.counts.sum()), out[0][2])
"""


def test_columnar_ingest_runs_without_jax(tmp_path):
    """The native ingest (snappy, the remote-write parser, the key map
    under add_rows_columnar) and stream aggregation run with jax, the JAX
    package and xxhash blocked."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", INGEST_PROBE,
                          str(tmp_path / "d")], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "INGESTED 35 7 35 2.0" in out.stdout, out.stdout


CONFIG_PROBE = r"""
import json, sys
for m in ("jax", "jaxlib", "xxhash", "victoriametrics_tpu", "yaml"):
    sys.modules[m] = None
from victoriametrics_tpu_torch.apps import vmagent, vmalert, vmalert_tool
from victoriametrics_tpu_torch.ingest import relabel, streamaggr
from victoriametrics_tpu_torch.utils import configfile
d = sys.argv[1]
groups, srv = vmalert.build(vmalert.parse_flags([
    f"-rule={d}/rules.json", "-httpListenAddr=127.0.0.1:0"]))
srv.stop()
agent, asrv = vmagent.build(vmagent.parse_flags([
    f"-promscrape.config={d}/scrape.json",
    f"-remoteWrite.tmpDataPath={d}/q", "-httpListenAddr=127.0.0.1:0"]))
asrv.stop()
targets = sorted(t.url for t in agent.targets.values())
agent.stop()
fails = vmalert_tool.run_test_file(f"{d}/t.json")
rc = relabel.parse_relabel_configs('[{"action": "drop"}]')
sa = streamaggr.load_from_text(
    '[{"interval": "1m", "outputs": ["count_samples"]}]', lambda rows: None)
sa.stop()
try:
    configfile.loads("a: [1", "bad.yml")
    named = False
except ValueError as e:  # configfile.ConfigError: a reload keeps the old
    named = "PyYAML" in str(e) and "bad.yml" in str(e)
try:
    with configfile.exit_on_error():  # at startup it ends the program
        configfile.loads("a: [1", "bad.yml")
except SystemExit as e:
    named = named and "PyYAML" in str(e.code) and "bad.yml" in str(e.code)
print("CONFIGS", json.dumps([[r.name for r in g.rules] for g in groups]),
      json.dumps(targets), json.dumps(fails), rc is not None, named,
      "yaml" in sys.modules and sys.modules["yaml"] is not None)
"""


def test_json_configs_load_without_pyyaml(tmp_path):
    """With PyYAML (and jax, the JAX package, xxhash) blocked, vmalert's
    rule files, vmagent's scrape config, vmalert_tool's test and rule
    files, relabeling and stream aggregation load from JSON through
    ``utils/configfile``; a file that is not JSON raises a ValueError
    naming PyYAML and the file, which ends the program at startup."""
    import json
    (tmp_path / "rules.json").write_text(json.dumps({"groups": [{
        "name": "g", "rules": [{"record": "r", "expr": "sum(m)"},
                               {"alert": "A", "expr": "m > 1"}]}]}))
    (tmp_path / "scrape.json").write_text(json.dumps({"scrape_configs": [{
        "job_name": "j",
        "static_configs": [{"targets": ["127.0.0.1:9"]}]}]}))
    (tmp_path / "t.json").write_text(json.dumps({
        "rule_files": ["rules.json"],
        "tests": [{"interval": "1m",
                   "input_series": [{"series": "m", "values": "0+1x5"}],
                   "metricsql_expr_test": [{
                       "expr": "m", "eval_time": "3m",
                       "exp_samples": [{"value": 3}]}]}]}))
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", CONFIG_PROBE,
                          str(tmp_path)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert 'CONFIGS [["r", "A"]] ["http://127.0.0.1:9/metrics"] [] ' \
        'True True False' in out.stdout, out.stdout + out.stderr[-2000:]


AUTH_PROBE = r"""
import json, sys
for m in ("jax", "jaxlib", "xxhash", "victoriametrics_tpu", "yaml"):
    sys.modules[m] = None
from victoriametrics_tpu_torch.apps import vmauth, vmbackup, vmctl
from victoriametrics_tpu_torch.utils import jwt, promtsdb
d = sys.argv[1]
auth, srv = vmauth.build(vmauth.parse_flags([
    f"-auth.config={d}/auth.json", "-httpListenAddr=127.0.0.1:0"]))
srv.stop()
users = [u.name for u in auth.users]
unauth = auth.unauthorized_user.route("/x", "")
try:
    vmauth.main([f"-auth.config={d}/auth.yml", "-httpListenAddr=127.0.0.1:0"])
    named = False
except SystemExit as e:
    named = "PyYAML" in str(e.code) and "auth.yml" in str(e.code)
print("AUTH", json.dumps(users), unauth, named,
      "yaml" in sys.modules and sys.modules["yaml"] is not None)
"""


def test_vmauth_config_loads_without_pyyaml(tmp_path):
    """With PyYAML (and jax, the JAX package, xxhash) blocked, vmauth,
    vmbackup, vmctl, jwt and promtsdb import, and vmauth's -auth.config
    loads from JSON (the reference's schema: users with basic
    auth, a bearer token, JWT secrets and claims, url_map, an
    unauthorized_user); a file that is not JSON ends startup naming
    PyYAML and the file."""
    import json
    (tmp_path / "auth.json").write_text(json.dumps({
        "users": [
            {"username": "u", "password": "p", "url_map": [
                {"src_paths": ["/api/v1/.*"],
                 "url_prefix": ["http://a1", "http://a2"]}]},
            {"bearer_token": "t", "url_prefix": "http://b"},
            {"name": "jwt", "url_prefix": "http://c",
             "jwt_secrets": ["s"], "jwt_required_claims": {"team": "dev"},
             "max_concurrent_requests": 2}],
        "unauthorized_user": {"url_prefix": "http://open"}}))
    (tmp_path / "auth.yml").write_text(
        "users:\n- username: u\n  password: p\n  url_prefix: http://a\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", AUTH_PROBE, str(tmp_path)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert 'AUTH ["u", "bearer", "jwt"] http://open True False' in \
        out.stdout, out.stdout + out.stderr[-2000:]
