"""JSON over HTTP on the stdlib, for the host-only jobs (the environment
servers and their clients); the card host has no aiohttp.

- ``JsonServer``: a ``ThreadingHTTPServer`` over a route table, each route
  a function of the JSON body (POST) or the query (GET) that returns
  ``(status, JSON object)``; ``GET /health`` answers ``health()``. It keeps
  a request log: per route, the count of each status it answered.
- ``JsonSession``: the asyncio client the rollouts use where the JAX
  package uses an ``aiohttp.ClientSession``: ``get(url, params=...)`` and
  ``post(url, json=...)``, each either awaited or used in ``async with``,
  give a response with ``status``, ``json()``, ``text()`` and
  ``raise_for_status()``. Each request is one connection through the
  engine client's code (``inference/http_client.py``).

Importing it loads no model, no engine and no kernel.
"""

from __future__ import annotations

import asyncio
import json
import logging
import threading
from collections import defaultdict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable
from urllib.parse import parse_qsl, urlencode, urlsplit

from ..inference.http_client import HTTPStatusError, _body_chunks, _open

logger = logging.getLogger(__name__)

# (JSON body for POST, or None for GET; query parameters) -> (status, JSON object)
Route = Callable[[Any, dict[str, str]], tuple[int, Any]]


class JsonServer:
    """Routes ``{(method, path): fn}`` behind a threading HTTP/1.1 server."""

    def __init__(self, routes: dict[tuple[str, str], Route], name: str = "json-server"):
        self.routes = {("GET", "/health"): lambda body, query: (200, self.health()), **routes}
        self.name = name
        self._log: dict[str, dict[str, int]] = defaultdict(lambda: defaultdict(int))
        self._log_lock = threading.Lock()
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def health(self) -> dict:
        return {"status": "ok"}

    def request_log(self) -> dict[str, dict[str, int]]:
        """Per route, how many requests it answered with each status."""
        with self._log_lock:
            return {path: dict(by_status) for path, by_status in self._log.items()}

    def handle(self, method: str, target: str, raw_body: bytes) -> tuple[int, Any]:
        parts = urlsplit(target)
        route = self.routes.get((method, parts.path))
        if route is None:
            status, out = 404, {"error": f"no route {method} {parts.path}"}
        else:
            try:
                body = json.loads(raw_body) if method == "POST" else None
                status, out = route(body, dict(parse_qsl(parts.query)))
            except json.JSONDecodeError as e:
                status, out = 400, {"error": f"invalid JSON body: {e}"}
            except Exception as e:  # noqa: BLE001 - a server answers every request
                logger.exception("%s %s failed", method, parts.path)
                status, out = 500, {"error": str(e)}
        with self._log_lock:
            self._log[parts.path][str(status)] += 1
        return status, out

    def start(self, host: str = "0.0.0.0", port: int = 0) -> int:
        """Serve on a thread; returns the bound port."""
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _answer(self, method: str) -> None:
                n = int(self.headers.get("Content-Length") or 0)
                status, out = server.handle(method, self.path, self.rfile.read(n) if n else b"")
                data = json.dumps(out).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802 - the stdlib's name
                self._answer("GET")

            def do_POST(self):  # noqa: N802
                self._answer("POST")

            def log_message(self, fmt, *args):
                logger.debug("%s: " + fmt, server.name, *args)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(target=self._server.serve_forever, name=self.name, daemon=True)
        self._thread.start()
        bound = self._server.server_address[1]
        logger.info("%s serving on %s:%d", self.name, host, bound)
        return bound

    def shutdown(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._thread.join(timeout=5)
            self._server = None


class JsonResponse:
    def __init__(self, status: int, data: bytes):
        self.status = status
        self._data = data

    async def json(self) -> Any:
        return json.loads(self._data)

    async def text(self) -> str:
        return self._data.decode()

    def raise_for_status(self) -> None:
        if self.status >= 400:
            raise HTTPStatusError(self.status, self._data)


class _Call:
    """One request: awaited, or entered with ``async with``."""

    def __init__(self, coro_fn: Callable[[], Any]):
        self._coro_fn = coro_fn

    def __await__(self):
        return self._coro_fn().__await__()

    async def __aenter__(self) -> JsonResponse:
        return await self._coro_fn()

    async def __aexit__(self, *exc) -> None:
        return None


class JsonSession:
    """Asyncio JSON client; ``timeout`` (seconds) bounds each request."""

    def __init__(self, timeout: float | None = 300.0):
        self.timeout = timeout

    def get(self, url: str, params: dict | None = None, timeout: float | None = None) -> _Call:
        if params:
            url = f"{url}{'&' if '?' in url else '?'}{urlencode(params)}"
        return _Call(lambda: self._request("GET", url, None, timeout))

    def post(self, url: str, json: Any = None, timeout: float | None = None) -> _Call:  # noqa: A002 - aiohttp's name
        return _Call(lambda: self._request("POST", url, json, timeout))

    async def _request(self, method: str, url: str, body: Any, timeout: float | None) -> JsonResponse:
        parts = urlsplit(url)
        base = f"{parts.scheme}://{parts.netloc}"
        target = parts.path + (f"?{parts.query}" if parts.query else "")

        async def go() -> JsonResponse:
            payload = None if method == "GET" else json.dumps(body).encode()
            reader, writer, status, headers = await _open(base, method, target, payload, "application/json")
            try:
                data = b"".join([c async for c in _body_chunks(reader, headers)])
            finally:
                writer.close()
            return JsonResponse(status, data)

        return await asyncio.wait_for(go(), timeout if timeout is not None else self.timeout)

    async def __aenter__(self) -> "JsonSession":
        return self

    async def __aexit__(self, *exc) -> None:
        return None
