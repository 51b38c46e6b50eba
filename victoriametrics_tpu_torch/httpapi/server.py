"""HTTP server shell (reference lib/httpserver/httpserver.go:113):
threaded stdlib server with route dispatch, gzip/zstd response compression,
optional basic auth, /metrics, /health, and graceful shutdown.

The port's copy of ``victoriametrics_tpu/httpapi/server.py``, whole.
"""

from __future__ import annotations

import gzip
import json
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..ingest.ratelimiter import RateLimitedError
from ..ops import compress as zstd
from ..parallel.rpc import (ClusterUnavailableError, PartialResultError,
                            RPCError)
from ..utils import logger
from ..utils import metrics as metricslib
from ..utils.workpool import SearchLimitError


class Request:
    def __init__(self, handler: BaseHTTPRequestHandler, body: bytes):
        self.handler = handler
        self.method = handler.command
        parsed = urllib.parse.urlparse(handler.path)
        self.path = parsed.path
        self.query = urllib.parse.parse_qs(parsed.query)
        self.headers = handler.headers
        self.body = body
        if self.method == "POST" and handler.headers.get(
                "Content-Type", "").startswith("application/x-www-form-urlencoded"):
            form = urllib.parse.parse_qs(body.decode("utf-8", "replace"))
            for k, v in form.items():
                self.query.setdefault(k, []).extend(v)

    def arg(self, name: str, default: str = "") -> str:
        vals = self.query.get(name)
        return vals[0] if vals else default

    def args(self, name: str) -> list[str]:
        return self.query.get(name, [])


class Response:
    def __init__(self, status=200, body=b"", content_type="application/json"):
        self.status = status
        self.body = body if isinstance(body, bytes) else body.encode()
        self.content_type = content_type
        self.headers: dict[str, str] = {}

    @classmethod
    def json(cls, obj, status=200):
        return cls(status, json.dumps(obj).encode(), "application/json")

    @classmethod
    def error(cls, msg: str, status=422, errtype="error"):
        return cls.json({"status": "error", "errorType": errtype,
                         "error": msg}, status=status)

    @classmethod
    def text(cls, s: str, status=200):
        return cls(status, s.encode(), "text/plain; charset=utf-8")


class StreamingResponse:
    """A chunked/streaming response (SSE push, long exports): `chunks`
    is an iterator of byte chunks written (and flushed) one at a time.
    No Content-Length; the connection closes when the iterator ends, so
    clients see a clean EOF.  Closing the generator (client disconnect)
    runs its ``finally`` blocks — handlers unsubscribe there."""

    def __init__(self, chunks, status: int = 200,
                 content_type: str = "text/event-stream",
                 headers: dict | None = None, on_close=None):
        self.chunks = chunks
        self.status = status
        self.content_type = content_type
        self.headers = dict(headers or {})
        #: cleanup invoked when the stream ends for ANY reason.  The
        #: generator's own finally blocks only run once it has STARTED —
        #: a client that disconnects before the first chunk (headers
        #: write raises) would otherwise leak whatever the handler
        #: registered (e.g. a watch subscription).
        self.on_close = on_close


class HTTPServer:
    """Route-dispatching server. Routes: exact path or prefix (trailing /)."""

    def __init__(self, addr: str = "127.0.0.1", port: int = 8428,
                 auth_key: str = "", basic_auth: tuple | None = None,
                 tls_cert_file: str = "", tls_key_file: str = ""):
        self.routes: dict[str, object] = {}
        self.prefix_routes: list[tuple[str, object]] = []
        self._path_metric_memo: dict[str, tuple] = {}
        self.auth_key = auth_key
        self.basic_auth = basic_auth
        # per-instance thread-safe counter (tests run several servers per
        # process; the per-path vm_http_requests_total metrics are global)
        self._request_count = metricslib.Counter("requests")
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                pass

            def _handle(self):
                outer._request_count.inc()
                ln = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(ln) if ln else b""
                enc = (self.headers.get("Content-Encoding") or "").lower()
                try:
                    if enc == "gzip":
                        body = gzip.decompress(body)
                    elif enc == "zstd":
                        body = zstd.decompress(body)
                    elif enc == "snappy":
                        from ..ingest import snappy as snappy_codec
                        body = snappy_codec.decompress(body)
                except Exception as e:
                    self._send(Response.error(f"cannot decompress body: {e}",
                                              400))
                    return
                req = Request(self, body)
                fn, pattern = outer._route_match(req.path)
                if fn is None:
                    # unmatched paths share one label: raw-path labels
                    # would let clients mint unbounded series
                    outer._path_metrics("*unsupported*")[0].inc()
                    self._send(Response.error(
                        f"unsupported path {req.path}", 404, "not_found"))
                    return
                requests, duration, errors = outer._path_metrics(pattern)
                requests.inc()
                t0 = time.perf_counter()
                try:
                    resp = fn(req)
                except RateLimitedError as e:
                    resp = Response.error(str(e), 429,
                                          "too_many_requests")
                    resp.headers["Retry-After"] = str(e.retry_after_s)
                except SearchLimitError as e:
                    # shed load from the (tenant) search gate on paths
                    # without their own handler mapping: same 429 +
                    # Retry-After contract as the ingest rate limiter
                    resp = Response.error(str(e), 429,
                                          "too_many_requests")
                    resp.headers["Retry-After"] = str(e.retry_after_s)
                except ClusterUnavailableError as e:
                    # no live storage at all: the promised 503 on every
                    # route, not just the query handlers' own arms
                    # (before RPCError — it is a subclass)
                    resp = Response.error(str(e), 503, "unavailable")
                except PartialResultError as e:
                    # deny_partial refusal: capacity degradation, 503
                    resp = Response.error(str(e), 503, "unavailable")
                except RPCError as e:
                    # a storage hop failed (protocol error, dead peer):
                    # the gateway is degraded, the serving code is not
                    # broken — 502, so clients and SLO burn rates can
                    # tell a bad backend from a serving bug
                    resp = Response.error(str(e), 502, "storage_rpc")
                except Exception as e:  # noqa: BLE001 - error boundary
                    logger.errorf("http handler %s: %s", req.path, e)
                    import traceback
                    traceback.print_exc()
                    resp = Response.error(str(e), 500, "internal")
                duration.update(time.perf_counter() - t0)
                if resp.status >= 500:
                    errors.inc()
                self._send(resp)

            def _send(self, resp: Response):
                if isinstance(resp, StreamingResponse):
                    self._send_stream(resp)
                    return
                body = resp.body
                accept = (self.headers.get("Accept-Encoding") or "")
                headers = dict(resp.headers)
                if len(body) > 256 and "gzip" in accept:
                    body = gzip.compress(body, 1)
                    headers["Content-Encoding"] = "gzip"
                try:
                    self.send_response(resp.status)
                    self.send_header("Content-Type", resp.content_type)
                    self.send_header("Content-Length", str(len(body)))
                    for k, v in headers.items():
                        self.send_header(k, v)
                    self.end_headers()
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def _send_stream(self, resp: "StreamingResponse"):
                # no Content-Length: the response ends when the chunk
                # iterator does, and the connection closes (HTTP/1.1
                # clients see Connection: close + EOF framing)
                self.close_connection = True
                chunks = resp.chunks
                try:
                    self.send_response(resp.status)
                    self.send_header("Content-Type", resp.content_type)
                    self.send_header("Cache-Control", "no-cache")
                    self.send_header("Connection", "close")
                    for k, v in resp.headers.items():
                        self.send_header(k, v)
                    self.end_headers()
                    for chunk in chunks:
                        self.wfile.write(chunk)
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass
                except Exception as e:  # noqa: BLE001 — mid-stream error
                    # headers are long gone: all we can do is log and
                    # close so the client sees the stream end
                    logger.errorf("streaming handler %s: %s",
                                  self.path, e)
                finally:
                    close = getattr(chunks, "close", None)
                    if close is not None:
                        close()  # runs a STARTED generator's finally
                    if resp.on_close is not None:
                        # runs even when the generator never started
                        # (close() skips finally blocks then)
                        try:
                            resp.on_close()
                        except Exception as e:  # noqa: BLE001
                            logger.errorf("stream on_close %s: %s",
                                          self.path, e)

            do_GET = do_POST = do_PUT = do_DELETE = _handle

        self._handler_cls = Handler
        self._srv = ThreadingHTTPServer((addr, port), Handler)
        self._srv.daemon_threads = True
        if tls_cert_file and tls_key_file:
            # -tls / -tlsCertFile / -tlsKeyFile (lib/httpserver TLS)
            import ssl
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(tls_cert_file, tls_key_file)
            self._srv.socket = ctx.wrap_socket(self._srv.socket,
                                               server_side=True)
            self.tls = True
        else:
            self.tls = False
        self.port = self._srv.server_address[1]
        self.addr = addr
        self._thread: threading.Thread | None = None

    @property
    def request_count(self) -> int:
        return self._request_count.get()

    def route(self, path: str, fn):
        if path.endswith("/"):
            self.prefix_routes.append((path, fn))
        else:
            self.routes[path] = fn

    def _path_metrics(self, pattern: str):
        """(requests counter, duration histogram, errors counter) for one
        route pattern, resolved once per pattern — keeps the name
        formatting and registry lock off the per-request path.  Patterns
        are the registered routes, so the memo is bounded."""
        m = self._path_metric_memo.get(pattern)
        if m is None:
            labels = {"path": pattern}
            m = self._path_metric_memo[pattern] = (
                metricslib.REGISTRY.counter(metricslib.format_name(
                    "vm_http_requests_total", labels)),
                metricslib.REGISTRY.histogram(metricslib.format_name(
                    "vm_request_duration_seconds", labels)),
                metricslib.REGISTRY.counter(metricslib.format_name(
                    "vm_http_request_errors_total", labels)))
        return m

    def _route_for(self, path: str):
        return self._route_match(path)[0]

    def _route_match(self, path: str):
        """(handler, route pattern) — the pattern (exact path or prefix)
        is the bounded-cardinality label for per-path metrics."""
        fn = self.routes.get(path)
        if fn is not None:
            return fn, path
        for prefix, pfn in self.prefix_routes:
            if path.startswith(prefix):
                return pfn, prefix
        return None, ""

    def start(self):
        self._started = True
        # long-lived HTTP accept loop, one per server — not fan-out work
        self._thread = threading.Thread(  # vmt: disable=VMT011
            target=self._srv.serve_forever, daemon=True)
        self._thread.start()
        logger.infof("http server listening on %s:%d", self.addr, self.port)

    def serve_forever(self):
        self._started = True
        self._srv.serve_forever()

    def stop(self):
        # BaseServer.shutdown() waits on a flag only serve_forever sets;
        # calling it on a never-started server would block forever.
        if getattr(self, "_started", False):
            self._srv.shutdown()
        self._srv.server_close()
