"""Threaded HTTP server shell of the control plane's REST faces.

The port's counterpart of ``adaptdl_tpu.sched.http_server``, on the
standard library's ``http.server.ThreadingHTTPServer`` instead of an
aiohttp event loop (a GPU host need not have aiohttp). The supervisor
needs JSON routes served from a background thread, so synchronous code
(the runners, trainers, tests) can start and stop it. Each request runs on a daemon thread of its
own, so a long poll holds one thread and blocks nobody else.

Routes are ``(method, pattern, handler)`` with aiohttp's ``{name}``
segments; a handler takes a :class:`Request` and returns a
:class:`Response`. The answers keep the JAX supervisor's shape: a JSON
body, an ``{"error": ...}`` envelope on every failure, 404 for an unknown
path, 405 for a known path under another method, and 500 when a handler
raises (aiohttp's status for an unhandled exception).
"""

from __future__ import annotations

import functools
import json
import logging
import re
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from adaptdl_tpu_torch import faults

LOG = logging.getLogger(__name__)

_SEGMENT = re.compile(r"\{(\w+)\}")


class Request:
    """One parsed request: method, path, ``query`` (first value of each
    key), ``match_info`` (the route's ``{name}`` segments, unquoted) and
    the raw body."""

    def __init__(self, method: str, path: str, query: dict, body: bytes):
        self.method = method
        self.path = path
        self.query = query
        self.body = body
        self.match_info: dict[str, str] = {}

    @property
    def can_read_body(self) -> bool:
        return bool(self.body)

    def json(self):
        """The body parsed as JSON; ``ValueError`` when it is not JSON
        (an empty body included), as aiohttp's ``request.json()``."""
        return json.loads(self.body.decode("utf-8"))


class Response:
    def __init__(self, status: int, body: bytes, headers: dict | None = None):
        self.status = status
        self.body = body
        self.headers = {"Content-Type": "application/json; charset=utf-8"}
        self.headers.update(headers or {})


def json_response(payload, status: int = 200, headers=None) -> Response:
    return Response(status, json.dumps(payload).encode("utf-8"), headers)


def error_response(message: str, status: int) -> Response:
    """The error envelope every failing route answers with."""
    return json_response({"error": message}, status=status)


def faultable(point: str):
    """Route a handler through a named injection point: an injected
    fault becomes a 500, the transient server error the resilient rpc
    client retries through."""

    def decorate(handler):
        @functools.wraps(handler)
        def wrapped(self, request: Request) -> Response:
            try:
                faults.maybe_fail(point)
            except faults.InjectedFault as exc:
                return error_response(f"injected fault: {exc}", 500)
            return handler(self, request)

        return wrapped

    return decorate


def _compile(pattern: str) -> re.Pattern:
    parts = _SEGMENT.split(pattern)
    regex = ""
    for i, part in enumerate(parts):
        # Odd entries are segment names; aiohttp matches [^{}/]+.
        regex += f"(?P<{part}>[^{{}}/]+)" if i % 2 else re.escape(part)
    return re.compile(f"^{regex}$")


class ThreadedHttpServer:
    """Serves :meth:`routes` from a daemon thread; ``start()`` returns
    the bound URL, ``stop()`` shuts the server and joins its thread."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._host = host
        self._port = port
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._table: list[tuple[str, re.Pattern, object]] = []

    def routes(self) -> list[tuple[str, str, object]]:  # pragma: no cover
        raise NotImplementedError

    def on_start(self) -> None:
        """Hook run once the socket is bound (background workers)."""

    def on_stop(self) -> None:
        """Hook run before the server shuts (wake and join workers)."""

    # -- dispatch ---------------------------------------------------------

    def dispatch(self, request: Request) -> Response:
        allowed = False
        for method, regex, handler in self._table:
            match = regex.match(request.path)
            if match is None:
                continue
            if method != request.method:
                allowed = True
                continue
            request.match_info = {
                k: urllib.parse.unquote(v) for k, v in match.groupdict().items()
            }
            try:
                return handler(request)
            except Exception as exc:  # noqa: BLE001 - answered as a 500
                LOG.exception("%s %s failed", request.method, request.path)
                return error_response(f"internal error: {exc!r}", 500)
        if allowed:
            return error_response("method not allowed", 405)
        return error_response("not found", 404)

    def _handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, format, *args):  # noqa: A002 - stdlib name
                LOG.debug("%s " + format, self.address_string(), *args)

            def _serve(self):
                parsed = urllib.parse.urlsplit(self.path)
                query = {
                    k: v[0]
                    for k, v in urllib.parse.parse_qs(
                        parsed.query, keep_blank_values=True
                    ).items()
                }
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length > 0 else b""
                response = server.dispatch(
                    Request(self.command, parsed.path, query, body)
                )
                self.send_response(response.status)
                for name, value in response.headers.items():
                    self.send_header(name, value)
                self.send_header("Content-Length", str(len(response.body)))
                self.end_headers()
                self.wfile.write(response.body)

            do_GET = do_PUT = do_POST = _serve  # noqa: N815

        return Handler

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> str:
        """Bind, start serving in a background thread, return the URL."""
        self._table = [
            (method, _compile(pattern), handler)
            for method, pattern, handler in self.routes()
        ]
        server = ThreadingHTTPServer(
            (self._host, self._port), self._handler_class()
        )
        server.daemon_threads = True
        self._server = server
        self._port = server.server_address[1]
        self._thread = threading.Thread(
            target=server.serve_forever,
            kwargs={"poll_interval": 0.1},
            name=type(self).__name__,
            daemon=True,
        )
        self._thread.start()
        self.on_start()
        return self.url

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self._port}"

    def stop(self) -> None:
        self.on_stop()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
