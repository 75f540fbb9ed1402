"""Route dispatch tables for the HTTP services — own copy of the
reference's ``predictionio_tpu/utils/routing.py``.

Handlers are plain functions `fn(Request) -> Response` registered once at
server construction with their route template; `Router.lookup` resolves
exact paths with one dict lookup and prefix routes (`/events/<id>.json`)
with a short scan. Handlers deal only in `Request`/`Response`; everything
socket-shaped stays in the transport.

The port's transport is the standard library's `ThreadingHTTPServer`
(as the prediction server's), adapted to a router by
`handler_from_router`: every handler runs on its connection's thread, as
in the reference's `PIO_HTTP_LOOP=0` path. The reference's selector event
loop (`utils/httploop.py`) is not ported, so a route's `blocking=` flag is
accepted and has no effect.
"""

from __future__ import annotations

from http.server import BaseHTTPRequestHandler
from typing import Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, unquote, urlparse

from predictionio_torch.utils import fastjson


class Headers:
    """Case-insensitive read-only header view (keys stored lowercase):
    `.get(name, default)` with case-insensitive names."""

    __slots__ = ("_d",)

    def __init__(self, d: Optional[dict] = None):
        self._d = d if d is not None else {}

    def get(self, name: str, default=None):
        return self._d.get(name.lower(), default)

    def __contains__(self, name: str) -> bool:
        return name.lower() in self._d


class Request:
    """One parsed HTTP request, transport-independent."""

    __slots__ = ("method", "target", "path", "headers", "body", "_params")

    def __init__(self, method: str, target: str, headers: Headers,
                 body: bytes, path: Optional[str] = None):
        self.method = method
        self.target = target          # raw request target incl. query
        self.path = path if path is not None else urlparse(target).path
        self.headers = headers
        self.body = body
        self._params: Optional[dict] = None

    @property
    def params(self) -> dict:
        """First-value query parameters."""
        if self._params is None:
            qs = parse_qs(urlparse(self.target).query)
            self._params = {k: v[0] for k, v in qs.items()}
        return self._params


class Response:
    """One response: status + headers + a body that is either prebuilt
    bytes or a payload rendered lazily by `render_body()`."""

    __slots__ = ("status", "body", "payload", "headers", "content_type")

    def __init__(self, status: int, *, body: Optional[bytes] = None,
                 payload=None, headers: Optional[dict] = None,
                 content_type: str = "application/json; charset=utf-8"):
        self.status = status
        self.body = body
        self.payload = payload
        self.headers = headers
        self.content_type = content_type

    @classmethod
    def json(cls, status: int, payload,
             headers: Optional[dict] = None) -> "Response":
        return cls(status, payload=payload, headers=headers)

    @classmethod
    def message(cls, status: int, message: str,
                headers: Optional[dict] = None) -> "Response":
        """`{"message": ...}` through the interned-body cache."""
        return cls(status, body=fastjson.message_body(message),
                   headers=headers)

    def render_body(self) -> bytes:
        if self.body is None:
            self.body = fastjson.dumps_bytes(self.payload)
        return self.body


class Route:
    __slots__ = ("fn", "template", "blocking")

    def __init__(self, fn: Callable[[Request], Response], template: str,
                 blocking: bool):
        self.fn = fn
        self.template = template
        self.blocking = blocking


class Router:
    """Pre-parsed dispatch table: exact paths resolve with one dict
    lookup, prefix routes (`/events/<id>.json`) with a short scan.
    Registered once at server construction — never rebuilt per request."""

    def __init__(self):
        self._exact: Dict[Tuple[str, str], Route] = {}
        self._prefix: Dict[str, List[Tuple[str, str, Route]]] = {}
        self._methods: set = set()

    # -- registration ------------------------------------------------------
    def add(self, method: str, path: str, fn, *, blocking: bool = False,
            template: Optional[str] = None) -> None:
        method = method.upper()
        self._methods.add(method)
        self._exact[(method, path)] = Route(fn, template or path, blocking)

    def add_prefix(self, method: str, prefix: str, suffix: str, fn, *,
                   template: str, blocking: bool = False) -> None:
        method = method.upper()
        self._methods.add(method)
        self._prefix.setdefault(method, []).append(
            (prefix, suffix, Route(fn, template, blocking)))

    def get(self, path: str, fn, **kw) -> None:
        self.add("GET", path, fn, **kw)

    def post(self, path: str, fn, **kw) -> None:
        self.add("POST", path, fn, **kw)

    def delete(self, path: str, fn, **kw) -> None:
        self.add("DELETE", path, fn, **kw)

    # -- dispatch ----------------------------------------------------------
    @property
    def methods(self) -> set:
        return set(self._methods)

    def lookup(self, method: str, path: str) -> Optional[Route]:
        route = self._exact.get((method, path))
        if route is not None:
            return route
        for prefix, suffix, r in self._prefix.get(method, ()):
            if path.startswith(prefix) and path.endswith(suffix):
                return r
        return None


def path_param(path: str, prefix: str, suffix: str) -> str:
    """Decode the variable segment of a prefix route
    (`/events/<id>.json` → id)."""
    return unquote(path[len(prefix):len(path) - len(suffix)])


NOT_FOUND = Response(404, body=fastjson.message_body("Not Found"))


def handler_from_router(router: Router):
    """A `BaseHTTPRequestHandler` subclass that dispatches every method
    the router knows through it (HTTP/1.1 keep-alive, TCP_NODELAY on the
    accepted socket); an unknown path answers `NOT_FOUND`."""

    def _dispatch(self, method: str) -> None:
        # read the body whatever the route does with it, so an answer
        # sent without it (a 401) leaves the keep-alive stream in step
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        target = self.path
        path = urlparse(target).path
        route = router.lookup(method, path)
        req = Request(method, target, Headers(
            {k.lower(): v for k, v in self.headers.items()}), body,
            path=path)
        resp = route.fn(req) if route is not None else NOT_FOUND
        payload = resp.render_body()
        self.send_response(resp.status)
        self.send_header("Content-Type", resp.content_type)
        self.send_header("Content-Length", str(len(payload)))
        for k, v in (resp.headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(payload)

    ns = {"protocol_version": "HTTP/1.1",
          # a response leaves as two writes (headers, body): with Nagle
          # on, a keep-alive client's delayed ACK holds the body back
          "disable_nagle_algorithm": True,
          "log_message": lambda self, fmt, *args: None}
    for method in sorted(router.methods):
        def do(self, _m=method):
            _dispatch(self, _m)
        do.__name__ = f"do_{method}"
        ns[f"do_{method}"] = do
    return type("RouterHandler", (BaseHTTPRequestHandler,), ns)
