"""The port's whole-program passes (``victoriametrics_tpu_torch/devtools/``
``callgraph.py``, ``deadline_taint.py`` VMT012, ``lockset.py`` VMT015,
``errorflow.py`` VMT016) against the reference's: the cases of
``tests/test_deadline_taint.py``, ``tests/test_lockset.py`` and
``tests/test_errorflow.py``, each written once and run on both packages
through the ``P`` fixture (``ref`` = the JAX package, ``port`` = the
PyTorch one).  Fixture packages synthesized in tmp_path must give the same
findings, and each package's own tree is clean.  The runtime halves (the
RPC pool's bounded acquire, the sloplane counters under the deterministic
scheduler, the typed RPC markers and HTTP arms) run on each package's own
modules.  The call graph of each package is built once a session."""

import importlib
import json
import textwrap
import threading
import types

import pytest


def _package(name: str):
    root = "victoriametrics_tpu" if name == "ref" else \
        "victoriametrics_tpu_torch"

    def mod(rel):
        return importlib.import_module(f"{root}.{rel}")
    return types.SimpleNamespace(
        name=name, root=root,
        callgraph=mod("devtools.callgraph"), dt=mod("devtools.deadline_taint"),
        ls=mod("devtools.lockset"), ef=mod("devtools.errorflow"),
        racetrace=mod("devtools.racetrace"), sched=mod("devtools.sched"),
        rpc=mod("parallel.rpc"), sloplane=mod("query.sloplane"),
        ratelimiter=mod("ingest.ratelimiter"), server=mod("httpapi.server"))


REF, PORT = _package("ref"), _package("port")


@pytest.fixture(params=["ref", "port"])
def P(request):
    return REF if request.param == "ref" else PORT


_GRAPHS: dict = {}


def _graph(P):
    """The package's whole-program call graph, built once."""
    if P.name not in _GRAPHS:
        _GRAPHS[P.name] = P.callgraph.build_callgraph(P.ef._default_paths())
    return _GRAPHS[P.name]


def test_default_paths_are_the_package(P):
    for m in (P.dt, P.ls, P.ef):
        (path,) = m._default_paths()
        assert path.endswith("/" + P.root)
    assert [b[1] for b in P.ef.BOUNDARIES] == [
        f"{P.root}/httpapi/server.py", f"{P.root}/parallel/rpc.py"]


@pytest.mark.parametrize("mod", ["dt", "ls", "ef"])
def test_repo_tree_findings_equal_in_both_packages(mod):
    """Each pass over each package's own tree finds what it finds over the
    other's: nothing (the port's copies carry their reasons inline)."""
    ref, _ = getattr(REF, mod).run_pass(_graph(REF))
    port, _ = getattr(PORT, mod).run_pass(_graph(PORT))
    assert [f.message for f in ref] == [] and [f.message for f in port] == []


# -- deadline taint (VMT012) --------------------------------------------------
def _write_pkg(tmp_path, body: str):
    d = tmp_path / "fixture_pkg"
    d.mkdir()
    (d / "srv.py").write_text(textwrap.dedent(body), encoding="utf-8")
    return d


# An RPC dispatch dict is recognized as a serving entry when it has
# >= 3 "*_vN" string keys mapping to same-module handler names.
_DISPATCH = """
        HANDLERS = {
            "a_v1": h_a,
            "b_v1": h_b,
            "c_v1": h_c,
        }
"""


def test_taint_blocking_call_behind_entry_is_flagged(P, tmp_path):
    pkg = _write_pkg(tmp_path, """
        import time

        def helper():
            time.sleep(0.5)

        def h_a(r, w):
            helper()

        def h_b(r, w):
            pass

        def h_c(r, w):
            pass
    """ + _DISPATCH)
    findings, _used = P.dt.run_pass(paths=[str(pkg)])
    assert len(findings) == 1, findings
    f = findings[0]
    assert f.rule == P.dt.RULE_ID
    assert "time.sleep" in f.message
    # the witness chain names the entry handler and the helper
    assert "h_a" in f.message and "helper" in f.message


def test_taint_deadline_seam_cuts_the_taint(P, tmp_path):
    """settimeout() on the socket before recv makes the def a seam —
    blocking below a seam is budgeted, not flagged."""
    pkg = _write_pkg(tmp_path, """
        import socket

        def helper(s):
            s.settimeout(2.0)
            return s.recv(16)

        def h_a(r, w):
            helper(socket.socket())

        def h_b(r, w):
            pass

        def h_c(r, w):
            pass
    """ + _DISPATCH)
    findings, _used = P.dt.run_pass(paths=[str(pkg)])
    assert findings == [], [f.message for f in findings]


def test_taint_suppressed_site_counts_as_used(P, tmp_path):
    pkg = _write_pkg(tmp_path, """
        import time

        def h_a(r, w):
            time.sleep(1)  # vmt: disable=VMT012

        def h_b(r, w):
            pass

        def h_c(r, w):
            pass
    """ + _DISPATCH)
    findings, used = P.dt.run_pass(paths=[str(pkg)])
    assert findings == [], [f.message for f in findings]
    # the disable comment is consumed -> VMT013 won't call it stale
    (rel,) = used
    assert any(rule == P.dt.RULE_ID for _ln, rule in used[rel])


def test_taint_unreachable_blocking_code_not_flagged(P, tmp_path):
    """Blocking outside the entry closure (no caller path) is out of
    scope for a *serving* latency pass."""
    pkg = _write_pkg(tmp_path, """
        import time

        def offline_maintenance():
            time.sleep(30)

        def h_a(r, w):
            pass

        def h_b(r, w):
            pass

        def h_c(r, w):
            pass
    """ + _DISPATCH)
    findings, _used = P.dt.run_pass(paths=[str(pkg)])
    assert findings == [], [f.message for f in findings]


def test_taint_repo_tree_is_clean(P):
    """The real tree carries ZERO baselined VMT012 findings — the pass
    found real gaps and they were fixed, not suppressed wholesale."""
    findings, _used = P.dt.run_pass(_graph(P))
    assert findings == [], [f.message for f in findings]


# -- the runtime fix VMT012 forced ------------------------------------------

def test_taint_pool_acquire_without_deadline_is_bounded(P, monkeypatch):
    """Deadline-free RPCClientPool._acquire must not park forever on the
    connection semaphore: it waits at most VM_RPC_ACQUIRE_MAX_S and then
    raises a retryable RPCError (waited=False -> safe to reroute)."""
    monkeypatch.setenv("VM_RPC_ACQUIRE_MAX_S", "0.05")
    pool = P.rpc.RPCClientPool("127.0.0.1", 1, b"hello", max_conns=1)
    assert pool._sem.acquire(timeout=1)  # wedge the only slot
    try:
        with pytest.raises(P.rpc.RPCError) as ei:
            pool._acquire("writeRows_v1", 0.0)
        assert not isinstance(ei.value, P.rpc.RPCDeadlineError)
        assert ei.value.waited is False
    finally:
        pool._sem.release()


def test_taint_pool_acquire_with_deadline_raises_deadline_error(P, monkeypatch):
    monkeypatch.setenv("VM_RPC_ACQUIRE_MAX_S", "5")
    pool = P.rpc.RPCClientPool("127.0.0.1", 1, b"hello", max_conns=1)
    assert pool._sem.acquire(timeout=1)
    try:
        import time
        with pytest.raises(P.rpc.RPCDeadlineError) as ei:
            pool._acquire("search_v1", time.monotonic() + 0.05)
        assert ei.value.waited is False
    finally:
        pool._sem.release()


# -- lockset (VMT015) -------------------------------------------------------

def test_lockset_unguarded_two_root_write_is_flagged(P, tmp_path):
    """Two serving entries funneling into the same unguarded module-
    global write: the race condition proper."""
    pkg = _write_pkg(tmp_path, """
        import threading

        STATS = {}
        MU = threading.Lock()

        def locked_read():
            with MU:
                return len(STATS)

        def bump():
            STATS["k"] = 1

        def h_a(r):
            bump()

        def h_b(r):
            bump()

        def h_c(r):
            pass
    """ + _DISPATCH)
    findings, _used = P.ls.run_pass(paths=[str(pkg)])
    assert len(findings) == 1, [f.message for f in findings]
    f = findings[0]
    assert f.rule == P.ls.RULE_ID
    assert "STATS" in f.message and "no consistent guard" in f.message
    # both witness chains name their entry handler
    assert "h_a" in f.message and "h_b" in f.message


def test_lockset_guarded_everywhere_is_clean(P, tmp_path):
    pkg = _write_pkg(tmp_path, """
        import threading

        STATS = {}
        MU = threading.Lock()

        def bump():
            with MU:
                STATS["k"] = 1

        def h_a(r):
            bump()

        def h_b(r):
            bump()

        def h_c(r):
            pass
    """ + _DISPATCH)
    findings, _used = P.ls.run_pass(paths=[str(pkg)])
    assert findings == [], [f.message for f in findings]


def test_lockset_mixed_guard_is_flagged(P, tmp_path):
    """One root takes the lock, the other does not — the disjoint pair
    is exactly the bug class (a 'mostly guarded' field is unguarded)."""
    pkg = _write_pkg(tmp_path, """
        import threading

        STATS = {}
        MU = threading.Lock()

        def bump_locked():
            with MU:
                STATS["k"] = 1

        def bump_bare():
            STATS["k"] = 2

        def h_a(r):
            bump_locked()

        def h_b(r):
            bump_bare()

        def h_c(r):
            pass
    """ + _DISPATCH)
    findings, _used = P.ls.run_pass(paths=[str(pkg)])
    assert len(findings) == 1, [f.message for f in findings]
    assert "bump_bare" in findings[0].message


def test_lockset_cross_call_guard_propagates(P, tmp_path):
    """The write site itself has no ``with`` — the lock is held by the
    CALLER on every path, which the per-root lockset intersection must
    recognize as a consistent guard."""
    pkg = _write_pkg(tmp_path, """
        import threading

        STATS = {}
        MU = threading.Lock()

        def inner():
            STATS["k"] = 1

        def outer():
            with MU:
                inner()

        def h_a(r):
            outer()

        def h_b(r):
            outer()

        def h_c(r):
            pass
    """ + _DISPATCH)
    findings, _used = P.ls.run_pass(paths=[str(pkg)])
    assert findings == [], [f.message for f in findings]


def test_lockset_cross_call_one_unlocked_path_is_flagged(P, tmp_path):
    """Same write site, but one root reaches it around the locked
    caller: the path intersection drops the lock and the pair races."""
    pkg = _write_pkg(tmp_path, """
        import threading

        STATS = {}
        MU = threading.Lock()

        def inner():
            STATS["k"] = 1

        def outer():
            with MU:
                inner()

        def h_a(r):
            outer()

        def h_b(r):
            inner()

        def h_c(r):
            pass
    """ + _DISPATCH)
    findings, _used = P.ls.run_pass(paths=[str(pkg)])
    assert len(findings) == 1, [f.message for f in findings]


def test_lockset_thread_target_is_a_root(P, tmp_path):
    """A ``threading.Thread(target=...)`` spawn makes the target its own
    concurrency root — one serving entry plus one background thread is
    already a two-root race."""
    pkg = _write_pkg(tmp_path, """
        import threading

        STATS = {}
        MU = threading.Lock()

        def locked_read():
            with MU:
                return len(STATS)

        def worker():
            STATS["k"] = 2

        def start():
            threading.Thread(target=worker).start()

        def h_a(r):
            STATS["k"] = 1

        def h_b(r):
            pass

        def h_c(r):
            pass
    """ + _DISPATCH)
    findings, _used = P.ls.run_pass(paths=[str(pkg)])
    assert len(findings) == 1, [f.message for f in findings]
    assert "thread worker" in findings[0].message


def test_lockset_single_root_is_not_flagged(P, tmp_path):
    """One root cannot race with itself — handler-serial mutation is
    out of scope no matter how unguarded it looks."""
    pkg = _write_pkg(tmp_path, """
        import threading

        STATS = {}
        MU = threading.Lock()

        def locked_read():
            with MU:
                return len(STATS)

        def h_a(r):
            STATS["k"] = 1

        def h_b(r):
            pass

        def h_c(r):
            pass
    """ + _DISPATCH)
    findings, _used = P.ls.run_pass(paths=[str(pkg)])
    assert findings == [], [f.message for f in findings]


def test_lockset_suppressed_access_site_counts_as_used(P, tmp_path):
    """A disable on ANY access site of the field suppresses the finding
    and is reported consumed (so VMT013 won't call it stale)."""
    pkg = _write_pkg(tmp_path, """
        import threading

        STATS = {}
        MU = threading.Lock()

        def locked_read():
            with MU:
                return len(STATS)

        def bump():
            STATS["k"] = 1  # vmt: disable=VMT015

        def h_a(r):
            bump()

        def h_b(r):
            bump()

        def h_c(r):
            pass
    """ + _DISPATCH)
    findings, used = P.ls.run_pass(paths=[str(pkg)])
    assert findings == [], [f.message for f in findings]
    (rel,) = used
    assert any(rule == P.ls.RULE_ID for _ln, rule in used[rel])


def test_lockset_repo_tree_is_clean(P):
    """The real tree carries ZERO baselined VMT015 findings — the races
    the pass found were fixed (or disabled with their invariant), not
    grandfathered."""
    findings, _used = P.ls.run_pass(_graph(P))
    assert findings == [], [f.message for f in findings]


# -- the runtime fix VMT015 forced ------------------------------------------

def test_lockset_sloplane_counters_keep_no_lost_updates(P):
    """VMT015 flagged SLOEngine.expr_evals: written from the self-scrape
    tick and the ``?pump=1`` HTTP seam with no common lock.  Pre-fix,
    the deterministic scheduler reproduced lost updates (9/12 at
    seed=1); post-fix (counters under the engine lock) every
    interleaving lands 12/12 with zero sanitizer reports."""
    racetrace, sched = P.racetrace, P.sched
    SLOEngine, SLOSpec = P.sloplane.SLOEngine, P.sloplane.SLOSpec

    class _Streams:
        def instant_vector(self, expr, ts_ms, tenant):
            return []

    class _API:
        matstreams = _Streams()

    names = ("expr_evals",)
    racetrace.traced_fields(*names)(SLOEngine)
    try:
        for seed in range(5):
            racetrace.reset()
            racetrace.enable()
            try:
                eng = SLOEngine(
                    api=_API(),
                    specs=[SLOSpec("t", 99.0,
                                   {"bad": "bad{w}", "total": "tot{w}"})],
                    windows=[("5m", "1h", 14.4)],
                    interval_s=0.05, period="24h")
                s = sched.DeterministicScheduler(seed=seed)
                s.spawn("t0", lambda: eng.maybe_eval(force=True))
                s.spawn("t1", lambda: eng.maybe_eval(force=True))
                s.run(timeout=30)
                # 2 rounds x 2 exprs x 3 windows
                assert eng.expr_evals == 12, \
                    f"seed={seed}: lost update ({eng.expr_evals}/12)"
                races = [r for r in racetrace.reports()
                         if r.field == "expr_evals"]
                assert races == [], races
            finally:
                racetrace.disable()
    finally:
        try:
            racetrace._registry.remove((SLOEngine, names))
        except ValueError:
            pass


# -- error flow (VMT016) ----------------------------------------------------

_TAIL = """
        def h_b(r):
            pass

        def h_c(r):
            pass

        HANDLERS = {
            "a_v1": h_a,
            "b_v1": h_b,
            "c_v1": h_c,
        }
"""


def _run(P, tmp_path, monkeypatch, body: str):
    d = tmp_path / "fixture_pkg"
    d.mkdir()
    p = d / "srv.py"
    p.write_text(textwrap.dedent(body + _TAIL), encoding="utf-8")
    # the fixture module IS the boundary: its _dispatch's top-level
    # except arms are the scanned mapped set
    monkeypatch.setattr(P.ef, "BOUNDARIES", (("rpc", str(p), "_dispatch"),))
    return P.ef.run_pass(paths=[str(p)])


def test_errorflow_unmapped_escape_is_flagged(P, tmp_path, monkeypatch):
    findings, _used = _run(P, tmp_path, monkeypatch, """
        class AppError(Exception):
            pass

        class MappedError(Exception):
            pass

        def _dispatch(r):
            try:
                return h_a(r)
            except MappedError as e:
                return ("mapped", str(e))

        def helper():
            raise AppError("boom")

        def h_a(r):
            helper()
    """)
    assert len(findings) == 1, [f.message for f in findings]
    f = findings[0]
    assert f.rule == P.ef.RULE_ID
    assert "AppError" in f.message and "rpc boundary" in f.message
    # witness chain: entry -> ... -> origin
    assert "h_a -> helper" in f.message
    # anchored at the raise site, not the entry
    assert "raise AppError" in open(f.path).read().splitlines()[f.line - 1]


def test_errorflow_boundary_mapping_retires_the_finding(P, tmp_path, monkeypatch):
    """Adding the typed except arm at the boundary is the fix — the
    mapped set is scanned from the AST, so the finding retires without
    touching the pass."""
    findings, _used = _run(P, tmp_path, monkeypatch, """
        class AppError(Exception):
            pass

        def _dispatch(r):
            try:
                return h_a(r)
            except AppError as e:
                return ("mapped", str(e))

        def helper():
            raise AppError("boom")

        def h_a(r):
            helper()
    """)
    assert findings == [], [f.message for f in findings]


def test_errorflow_mapping_covers_subclasses(P, tmp_path, monkeypatch):
    """``except Base`` at the boundary maps every derived type — the
    catch test walks the project class hierarchy."""
    findings, _used = _run(P, tmp_path, monkeypatch, """
        class AppError(Exception):
            pass

        class SubError(AppError):
            pass

        def _dispatch(r):
            try:
                return h_a(r)
            except AppError as e:
                return ("mapped", str(e))

        def h_a(r):
            raise SubError("boom")
    """)
    assert findings == [], [f.message for f in findings]


def test_errorflow_reraise_as_mapped_type_is_clean(P, tmp_path, monkeypatch):
    """Catching en route and re-raising as an already-mapped type is a
    sanctioned translation, not an escape."""
    findings, _used = _run(P, tmp_path, monkeypatch, """
        class AppError(Exception):
            pass

        class MappedError(Exception):
            pass

        def _dispatch(r):
            try:
                return h_a(r)
            except MappedError as e:
                return ("mapped", str(e))

        def helper():
            raise AppError("boom")

        def h_a(r):
            try:
                helper()
            except AppError as e:
                raise MappedError(str(e))
    """)
    assert findings == [], [f.message for f in findings]


def test_errorflow_swallowed_en_route_is_clean(P, tmp_path, monkeypatch):
    findings, _used = _run(P, tmp_path, monkeypatch, """
        class AppError(Exception):
            pass

        class MappedError(Exception):
            pass

        def _dispatch(r):
            try:
                return h_a(r)
            except MappedError as e:
                return ("mapped", str(e))

        def helper():
            raise AppError("boom")

        def h_a(r):
            try:
                helper()
            except AppError:
                return None
    """)
    assert findings == [], [f.message for f in findings]


def test_errorflow_ext_raiser_builtin_is_flagged(P, tmp_path, monkeypatch):
    """json.loads on untrusted bytes raises ValueError — a documented
    external raiser IS flagged (unlike bare project-raised builtins)."""
    findings, _used = _run(P, tmp_path, monkeypatch, """
        import json

        class MappedError(Exception):
            pass

        def _dispatch(r):
            try:
                return h_a(r)
            except MappedError as e:
                return ("mapped", str(e))

        def h_a(r):
            return json.loads(r)
    """)
    assert len(findings) == 1, [f.message for f in findings]
    assert "json.loads()" in findings[0].message


def test_errorflow_bare_builtin_raise_is_not_flagged(P, tmp_path, monkeypatch):
    """A validator raising ValueError itself is handler-layer 4xx
    territory, not a boundary-contract gap."""
    findings, _used = _run(P, tmp_path, monkeypatch, """
        class MappedError(Exception):
            pass

        def _dispatch(r):
            try:
                return h_a(r)
            except MappedError as e:
                return ("mapped", str(e))

        def h_a(r):
            raise ValueError("bad arg")
    """)
    assert findings == [], [f.message for f in findings]


def test_errorflow_suppressed_raise_site_counts_as_used(P, tmp_path, monkeypatch):
    findings, used = _run(P, tmp_path, monkeypatch, """
        class AppError(Exception):
            pass

        class MappedError(Exception):
            pass

        def _dispatch(r):
            try:
                return h_a(r)
            except MappedError as e:
                return ("mapped", str(e))

        def h_a(r):
            raise AppError("ok")  # vmt: disable=VMT016
    """)
    assert findings == [], [f.message for f in findings]
    (rel,) = used
    assert any(rule == P.ef.RULE_ID for _ln, rule in used[rel])


# -- the real tree's boundary contract --------------------------------------

def test_errorflow_real_boundaries_map_the_typed_failures(P):
    """The scanned mapped sets carry the full contract: every typed
    capacity/degradation failure has a non-anonymous arm at both
    boundaries."""
    g = _graph(P)
    bounds = P.ef.boundary_mappings(g)
    http = {k.rpartition("::")[2].rpartition(".")[2]
            for k in bounds["http"]["mapped"]}
    for name in ("RateLimitedError", "SearchLimitError",
                 "ClusterUnavailableError", "PartialResultError",
                 "RPCError"):
        assert name in http, (name, sorted(http))
    rpc = {k.rpartition("::")[2].rpartition(".")[2]
           for k in bounds["rpc"]["mapped"]}
    for name in ("RateLimitedError", "SearchLimitError",
                 "ClusterUnavailableError", "PartialResultError",
                 "RPCError", "DeadlineExceededError"):
        assert name in rpc, (name, sorted(rpc))


def test_errorflow_repo_tree_is_clean(P):
    """The real tree carries ZERO baselined VMT016 findings — the
    escapes the pass found got typed mappings (or their invariant
    disables), not a grandfather list."""
    findings, _used = P.ef.run_pass(_graph(P))
    assert findings == [], [f.message for f in findings]


# -- the runtime fixes VMT016 forced ----------------------------------------

def test_errorflow_rpc_typed_errors_reraise_client_side(P):
    """The wire markers VMT016 forced: RateLimitedError crosses as
    vm:rate-limited (retry_after_s preserved), ClusterUnavailableError
    as vm:unavailable, PartialResultError as vm:partial-denied, and a
    generic RPCError still round-trips as exactly RPCError."""
    RateLimitedError = P.ratelimiter.RateLimitedError
    rpc = P.rpc
    HELLO_SELECT, ClusterUnavailableError, PartialResultError = \
        rpc.HELLO_SELECT, rpc.ClusterUnavailableError, rpc.PartialResultError
    RPCClient, RPCError, RPCServer, Writer = \
        rpc.RPCClient, rpc.RPCError, rpc.RPCServer, rpc.Writer

    def h_rate(r):
        raise RateLimitedError(7.2)

    def h_unavail(r):
        raise ClusterUnavailableError("no live storage node")

    def h_partial(r):
        raise PartialResultError("1 of 2 nodes answered")

    def h_generic(r):
        raise RPCError("rpc: truncated bytes field")

    srv = RPCServer("127.0.0.1", 0, HELLO_SELECT,
                    {"rate_v1": h_rate, "unavail_v1": h_unavail,
                     "partial_v1": h_partial, "generic_v1": h_generic})
    srv.start()
    c = RPCClient("127.0.0.1", srv.port, HELLO_SELECT, timeout=30.0)
    try:
        with pytest.raises(RateLimitedError) as ei:
            c.call("rate_v1", Writer())
        assert ei.value.retry_after_s == 8  # ceil(7.2)
        with pytest.raises(ClusterUnavailableError) as ei:
            c.call("unavail_v1", Writer())
        assert "no live storage node" in str(ei.value)
        with pytest.raises(PartialResultError) as ei:
            c.call("partial_v1", Writer())
        assert "1 of 2 nodes" in str(ei.value)
        with pytest.raises(RPCError) as ei:
            c.call("generic_v1", Writer())
        assert type(ei.value) is RPCError
        assert "truncated bytes" in str(ei.value)
    finally:
        c.close()
        srv.stop()


def test_errorflow_http_boundary_maps_cluster_errors(P):
    """The HTTP arms VMT016 forced: ClusterUnavailableError -> 503
    "unavailable" (capacity: retry elsewhere/later), PartialResultError
    -> 503, RPCError -> 502 "storage_rpc" (bad backend, not a serving
    bug) — never the anonymous 500."""
    from apptest_helpers import Client
    HTTPServer = P.server.HTTPServer
    ClusterUnavailableError, PartialResultError, RPCError = \
        P.rpc.ClusterUnavailableError, P.rpc.PartialResultError, P.rpc.RPCError

    srv = HTTPServer(port=0)
    srv.route("/boom/unavail",
              lambda req: (_ for _ in ()).throw(
                  ClusterUnavailableError("no node")))
    srv.route("/boom/partial",
              lambda req: (_ for _ in ()).throw(
                  PartialResultError("denied")))
    srv.route("/boom/rpc",
              lambda req: (_ for _ in ()).throw(
                  RPCError("peer hung up")))
    srv.start()
    cli = Client(srv.port)
    try:
        code, body = cli.get("/boom/unavail")
        assert code == 503, body
        assert json.loads(body)["errorType"] == "unavailable"
        code, body = cli.get("/boom/partial")
        assert code == 503, body
        assert json.loads(body)["errorType"] == "unavailable"
        code, body = cli.get("/boom/rpc")
        assert code == 502, body
        assert json.loads(body)["errorType"] == "storage_rpc"
    finally:
        srv.stop()
