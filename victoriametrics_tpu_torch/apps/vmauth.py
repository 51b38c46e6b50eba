"""vmauth: auth proxy / load balancer (reference app/vmauth: YAML users with
url_map routing by src_paths, load-balancing across url_prefix lists,
basic-auth + bearer-token + JWT matching, unauthorized_user fallback).

Run: python -m victoriametrics_tpu_torch.apps.vmauth -auth.config=auth.json
-httpListenAddr=:8427

The port's copy of ``victoriametrics_tpu/apps/vmauth.py``, with two
departures: its ``-auth.config`` loads through ``utils/configfile``
(PyYAML where it is installed, else JSON, with the same schema), and a
file that neither reads ends startup naming PyYAML and the file; and a
basic credential matches only a user that has a username, so an empty one
(``Basic Og==``) is not let in as a bearer-token or JWT user."""

from __future__ import annotations

import argparse
import base64
import itertools
import re
import signal
import threading
import urllib.parse
import urllib.request

from ..utils import configfile, logger


class Backend:
    """A url_prefix group with round-robin (least-loaded approximation)."""

    def __init__(self, prefixes):
        if isinstance(prefixes, str):
            prefixes = [prefixes]
        self.prefixes = [p.rstrip("/") for p in prefixes]
        self._rr = itertools.cycle(range(len(self.prefixes)))
        self._lock = threading.Lock()

    def pick(self) -> str:
        with self._lock:
            return self.prefixes[next(self._rr)]


class URLMapEntry:
    def __init__(self, cfg: dict):
        self.src_paths = [re.compile("(?:" + p + ")\\Z")
                          for p in cfg.get("src_paths", [])]
        self.src_hosts = [re.compile("(?:" + p + ")\\Z")
                          for p in cfg.get("src_hosts", [])]
        self.backend = Backend(cfg["url_prefix"])

    def matches(self, path: str, host: str) -> bool:
        if self.src_paths and not any(r.match(path) for r in self.src_paths):
            return False
        if self.src_hosts and not any(r.match(host) for r in self.src_hosts):
            return False
        return True


class User:
    def __init__(self, cfg: dict):
        self.username = cfg.get("username", "")
        self.password = cfg.get("password", "")
        self.bearer_token = cfg.get("bearer_token", "")
        # JWT auth (lib/jwt analog): HS* shared secrets and/or RS256 PEM
        # public keys; optional required claims, e.g. {"vm_access": ...}
        self.jwt_secrets = list(cfg.get("jwt_secrets", []) or [])
        self.jwt_public_keys = list(cfg.get("jwt_public_keys", []) or [])
        self.jwt_claims = dict(cfg.get("jwt_required_claims", {}) or {})
        self.name = cfg.get("name", self.username or "bearer")
        self.url_map = [URLMapEntry(m) for m in cfg.get("url_map", [])]
        self.default_backend = (Backend(cfg["url_prefix"])
                                if cfg.get("url_prefix") else None)
        self.max_concurrent = int(cfg.get("max_concurrent_requests", 0))
        self._sem = (threading.Semaphore(self.max_concurrent)
                     if self.max_concurrent else None)
        self.requests = 0

    def route(self, path: str, host: str) -> str | None:
        for entry in self.url_map:
            if entry.matches(path, host):
                return entry.backend.pick()
        if self.default_backend is not None:
            return self.default_backend.pick()
        return None


class AuthConfig:
    def __init__(self, cfg: dict):
        self.users = [User(u) for u in cfg.get("users", [])]
        uu = cfg.get("unauthorized_user")
        self.unauthorized_user = User(uu) if uu else None

    def find_user(self, headers) -> User | None:
        auth = headers.get("Authorization", "")
        if auth.startswith("Bearer "):
            token = auth[7:]
            for u in self.users:
                if u.bearer_token and u.bearer_token == token:
                    return u
            if token.count(".") == 2:
                from ..utils.jwt import JWTError, verify
                for u in self.users:
                    if not (u.jwt_secrets or u.jwt_public_keys):
                        continue
                    try:
                        claims = verify(token, u.jwt_secrets,
                                        u.jwt_public_keys)
                    except JWTError:
                        continue
                    if all(claims.get(k) == v
                           for k, v in u.jwt_claims.items()):
                        return u
        if auth.startswith("Basic "):
            try:
                dec = base64.b64decode(auth[6:]).decode()
                name, _, pwd = dec.partition(":")
            except Exception:
                return None
            for u in self.users:
                if u.username and u.username == name and \
                        u.password == pwd:
                    return u
        return None


def build(args):
    from ..httpapi.server import HTTPServer, Request, Response

    cfg = configfile.load(args.auth_config) or {}
    auth = AuthConfig(cfg)
    hh, _, hp = args.httpListenAddr.rpartition(":")
    srv = HTTPServer(hh or "0.0.0.0", int(hp))

    def proxy(req: Request) -> Response:
        user = auth.find_user(req.headers)
        if user is None:
            user = auth.unauthorized_user
        if user is None:
            resp = Response.text("missing or invalid auth", 401)
            resp.headers["WWW-Authenticate"] = 'Basic realm="vmauth"'
            return resp
        host = req.headers.get("Host", "")
        target = user.route(req.path, host)
        if target is None:
            return Response.text("no route for path", 400)
        user.requests += 1
        if user._sem is not None and not user._sem.acquire(timeout=10):
            return Response.text("too many concurrent requests", 429)
        try:
            qs = ""
            if req.query:
                qs = "?" + urllib.parse.urlencode(
                    [(k, v) for k, vs in req.query.items() for v in vs])
            url = target + req.path + qs
            fwd = urllib.request.Request(
                url, data=req.body if req.method in ("POST", "PUT") else None,
                method=req.method)
            ct = req.headers.get("Content-Type")
            if ct:
                fwd.add_header("Content-Type", ct)
            try:
                with urllib.request.urlopen(fwd, timeout=60) as r:
                    return Response(r.status, r.read(),
                                    r.headers.get("Content-Type",
                                                  "application/json"))
            except urllib.error.HTTPError as e:
                return Response(e.code, e.read(),
                                e.headers.get("Content-Type", "text/plain"))
            except OSError as e:
                return Response.text(f"backend error: {e}", 502)
        finally:
            if user._sem is not None:
                user._sem.release()

    srv.route("/", proxy)  # prefix: everything
    srv.routes["/health"] = lambda req: Response.text("OK")
    return auth, srv


def parse_flags(argv=None):
    p = argparse.ArgumentParser(prog="vmauth")
    p.add_argument("-auth.config", dest="auth_config", required=True)
    p.add_argument("-httpListenAddr", default=":8427")
    p.add_argument("-loggerLevel", default="INFO")
    args, _ = p.parse_known_args(argv)
    return args


def main(argv=None):
    import faulthandler
    faulthandler.register(signal.SIGUSR1)
    args = parse_flags(argv)
    logger.set_level(args.loggerLevel)
    with configfile.exit_on_error():
        _auth, srv = build(args)
    srv.start()
    logger.infof("vmauth started: http=%d", srv.port)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    try:
        while not stop.wait(1.0):
            pass
    finally:
        srv.stop()


if __name__ == "__main__":
    main()
