"""A small HTTP/1.1 server on asyncio streams.

The JAX package's OpenAI frontend (dynamo_tpu/frontend/service.py) serves
with aiohttp, which the machines the port serves on do not have.  This
server gives the port's frontend (frontend/service.py) what that service
uses of aiohttp, under the same names, and nothing more:

  * the request line, headers looked up case-insensitively (`Headers`,
    what aiohttp's CIMultiDict gives `session_affinity_from_headers`),
    the query string, and bodies framed by `Content-Length` or chunked
    transfer coding, up to aiohttp's default `client_max_size` of 1 MiB
    (413 past it); `Expect: 100-continue` is answered;
  * `Response` / `json_response` (`application/json; charset=utf-8`),
    and aiohttp's plain-text 404, 405, 413 and 500 for unknown routes,
    wrong methods, oversized bodies and handlers that raise;
  * keep-alive: a connection serves requests one after another until
    the client asks to close or stays idle for `KEEPALIVE_TIMEOUT_S`
    (aiohttp's 75 s), so a benchmark's client pays no connect per
    request;
  * `StreamResponse`: `prepare` writes the head, each `write` sends one
    chunk of chunked transfer coding and drains it, so every
    `text/event-stream` event leaves when it is written, and
    `write_eof` ends the body;
  * a client that goes away while its request is handled: the
    connection's reader is watched for the end of the stream during the
    handler, and the handler task is cancelled when it comes (the
    frontend turns that into `CancellationToken.kill`, which reaches
    the worker); a write to a closed connection raises
    ConnectionResetError, as aiohttp's does;
  * `close()`: stops listening and cancels every connection, which ends
    the streams still open.

A handler is `async def handler(request) -> Response | StreamResponse`,
registered with `add_get` / `add_post`.
"""

from __future__ import annotations

import asyncio
import json as _json
import logging
from collections.abc import Mapping
from http import HTTPStatus
from typing import Awaitable, Callable, Dict, Iterator, Optional, Tuple, Union
from urllib.parse import parse_qs, urlsplit

logger = logging.getLogger(__name__)

MAX_HEAD_BYTES = 65536
MAX_BODY_BYTES = 1024 ** 2  # aiohttp's default client_max_size
KEEPALIVE_TIMEOUT_S = 75.0  # aiohttp's default keepalive_timeout
BODY_TIMEOUT_S = 60.0
_READ_SIZE = 65536

JSON_TYPE = "application/json; charset=utf-8"


class Headers(Mapping):
    """Request headers with case-insensitive names (the first value of a
    repeated header wins, as CIMultiDict.get gives it)."""

    def __init__(self, items=()):
        self._d: Dict[str, str] = {}
        self._names: Dict[str, str] = {}
        for k, v in items:
            key = k.lower()
            if key not in self._d:
                self._d[key] = v
                self._names[key] = k

    def __getitem__(self, name: str) -> str:
        return self._d[name.lower()]

    def __iter__(self) -> Iterator[str]:
        return iter(self._names.values())

    def __len__(self) -> int:
        return len(self._d)


class Request:
    """One request: method, path, query (first value per key), headers
    and the whole body."""

    def __init__(self, method: str, target: str, headers: Headers,
                 body: bytes, conn: "_Conn"):
        self.method = method
        parts = urlsplit(target)
        self.path = parts.path
        self.query = {k: v[0] for k, v in
                      parse_qs(parts.query, keep_blank_values=True).items()}
        self.headers = headers
        self.body = body
        self._conn = conn

    async def text(self) -> str:
        return self.body.decode("utf-8")

    async def json(self):
        """The body as JSON; json.JSONDecodeError when it is not."""
        return _json.loads(await self.text())


class Response:
    """A whole response: status, body and content type."""

    def __init__(self, *, body: bytes = b"", status: int = 200,
                 content_type: str = "application/octet-stream",
                 headers: Optional[Dict[str, str]] = None,
                 text: Optional[str] = None):
        if text is not None:
            body = text.encode("utf-8")
            if content_type == "application/octet-stream":
                content_type = "text/plain; charset=utf-8"
        self.status = status
        self.body = body
        self.content_type = content_type
        self.headers = dict(headers or {})


def json_response(data, *, status: int = 200,
                  headers: Optional[Dict[str, str]] = None) -> Response:
    return Response(body=_json.dumps(data).encode(), status=status,
                    content_type=JSON_TYPE, headers=headers)


def _plain_error(status: int) -> Response:
    # aiohttp's body for the errors it raises itself
    return Response(text=f"{status}: {HTTPStatus(status).phrase}",
                    status=status)


def _head_bytes(status: int, headers: Dict[str, str]) -> bytes:
    return (f"HTTP/1.1 {status} {HTTPStatus(status).phrase}\r\n"
            + "".join(f"{k}: {v}\r\n" for k, v in headers.items())
            + "\r\n").encode("latin-1")


class StreamResponse:
    """A response written as it is made: the head at `prepare`, then one
    chunk of chunked transfer coding per `write`, drained before the
    call returns."""

    def __init__(self, *, status: int = 200,
                 headers: Optional[Dict[str, str]] = None):
        self.status = status
        self.headers = dict(headers or {})
        self.prepared = False
        self.eof = False
        self._conn: Optional[_Conn] = None

    async def prepare(self, request: Request) -> "StreamResponse":
        conn = request._conn
        self._conn = conn
        hdrs = dict(self.headers)
        hdrs["Transfer-Encoding"] = "chunked"
        hdrs["Connection"] = "keep-alive" if conn.keep_alive else "close"
        await conn.send(_head_bytes(self.status, hdrs))
        self.prepared = True
        return self

    async def write(self, data: bytes) -> None:
        if not self.prepared or self.eof:
            raise RuntimeError("write on a response that is not open")
        if data:
            await self._conn.send(b"%x\r\n%s\r\n" % (len(data), data))

    async def write_eof(self) -> None:
        if self.eof:
            return
        self.eof = True
        if self.prepared:
            await self._conn.send(b"0\r\n\r\n")


Handler = Callable[[Request], Awaitable[Union[Response, StreamResponse]]]


class _BadRequest(Exception):
    def __init__(self, status: int):
        super().__init__(status)
        self.status = status


class _Conn:
    """One client connection: a byte buffer over its reader (the
    disconnect watcher reads ahead into it), the writer, and whether
    the connection stays open after the current response."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self.buf = bytearray()
        self.eof = False
        self.keep_alive = True

    async def _fill(self) -> None:
        data = await self.reader.read(_READ_SIZE)
        if not data:
            self.eof = True
            raise ConnectionError("connection closed")
        self.buf += data

    async def read_head(self) -> Optional[bytes]:
        """The next request head, or None when the client closed the
        connection between requests."""
        while True:
            i = self.buf.find(b"\r\n\r\n")
            if i >= 0:
                head = bytes(self.buf[:i + 4])
                del self.buf[:i + 4]
                return head
            if len(self.buf) > MAX_HEAD_BYTES:
                raise _BadRequest(431)
            if self.eof:
                return None
            try:
                await self._fill()
            except ConnectionError:
                if self.buf.strip():
                    raise
                return None

    async def read_exactly(self, n: int) -> bytes:
        while len(self.buf) < n:
            await self._fill()
        data = bytes(self.buf[:n])
        del self.buf[:n]
        return data

    async def read_line(self) -> bytes:
        while True:
            i = self.buf.find(b"\r\n")
            if i >= 0:
                line = bytes(self.buf[:i])
                del self.buf[:i + 2]
                return line
            if len(self.buf) > MAX_HEAD_BYTES:
                raise _BadRequest(400)
            await self._fill()

    async def watch(self, task: asyncio.Task) -> None:
        """Read ahead while `task` handles a request; cancel it when the
        client closes the connection (bytes that arrive are kept for
        the next request)."""
        while not self.eof:
            try:
                data = await self.reader.read(_READ_SIZE)
            except (ConnectionError, OSError):
                data = b""
            if not data:
                self.eof = True
                self.keep_alive = False
                task.cancel()
                return
            self.buf += data

    async def send(self, data: bytes) -> None:
        if self.writer.is_closing():
            raise ConnectionResetError("Cannot write to closing transport")
        self.writer.write(data)
        await self.writer.drain()


class HttpServer:
    """Routes (method, path) to handlers; `start` binds `host:port` (port
    0 picks a free one, read back from `bound_port`)."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0):
        self.host = host
        self.port = port
        self.bound_port: Optional[int] = None
        self._routes: Dict[Tuple[str, str], Handler] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._conn_tasks: set = set()
        self._closing = False

    def add_route(self, method: str, path: str, handler: Handler) -> None:
        self._routes[(method.upper(), path)] = handler

    def add_get(self, path: str, handler: Handler) -> None:
        self.add_route("GET", path, handler)

    def add_post(self, path: str, handler: Handler) -> None:
        self.add_route("POST", path, handler)

    async def start(self) -> "HttpServer":
        self._server = await asyncio.start_server(
            self._on_connect, self.host, self.port)
        self.bound_port = self._server.sockets[0].getsockname()[1]
        return self

    async def close(self) -> None:
        """Stop listening and end every connection, open streams
        included (their handlers are cancelled)."""
        self._closing = True
        if self._server is not None:
            self._server.close()
        tasks = list(self._conn_tasks)
        for t in tasks:
            t.cancel()
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
        if self._server is not None:
            await self._server.wait_closed()
            self._server = None

    # -- connections ------------------------------------------------------
    async def _on_connect(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        if self._closing:
            writer.close()
            return
        self._conn_tasks.add(task)
        conn = _Conn(reader, writer)
        try:
            while not self._closing:
                try:
                    head = await asyncio.wait_for(conn.read_head(),
                                                  KEEPALIVE_TIMEOUT_S)
                except _BadRequest as e:
                    await self._send_whole(conn, _plain_error(e.status),
                                           False)
                    return
                except (asyncio.TimeoutError, ConnectionError, OSError):
                    return
                if head is None:
                    return
                try:
                    request = await asyncio.wait_for(
                        self._parse(conn, head), BODY_TIMEOUT_S)
                except _BadRequest as e:
                    await self._send_whole(conn, _plain_error(e.status),
                                           False)
                    return
                except (asyncio.TimeoutError, ConnectionError, OSError,
                        asyncio.IncompleteReadError):
                    return
                if not await self._respond(conn, request):
                    return
        except (ConnectionError, OSError):
            pass
        except asyncio.CancelledError:
            pass
        finally:
            self._conn_tasks.discard(task)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError, asyncio.CancelledError):
                pass

    async def _parse(self, conn: _Conn, head: bytes) -> Request:
        lines = head.decode("latin-1").split("\r\n")
        parts = lines[0].split(" ")
        if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
            raise _BadRequest(400)
        method, target, version = parts
        items = []
        for line in lines[1:]:
            if not line:
                continue
            if ":" not in line:
                raise _BadRequest(400)
            k, v = line.split(":", 1)
            items.append((k.strip(), v.strip()))
        headers = Headers(items)
        conn_hdr = headers.get("connection", "").lower()
        conn.keep_alive = ("close" not in conn_hdr
                           if version == "HTTP/1.1"
                           else "keep-alive" in conn_hdr)
        chunked = "chunked" in headers.get("transfer-encoding", "").lower()
        try:
            length = int(headers.get("content-length", "0"))
        except ValueError:
            raise _BadRequest(400) from None
        if length < 0:
            raise _BadRequest(400)
        if length > MAX_BODY_BYTES:
            raise _BadRequest(413)
        if (chunked or length) and headers.get(
                "expect", "").lower() == "100-continue":
            await conn.send(b"HTTP/1.1 100 Continue\r\n\r\n")
        if chunked:
            body = bytearray()
            while True:
                line = await conn.read_line()
                try:
                    size = int(line.split(b";", 1)[0].strip(), 16)
                except ValueError:
                    raise _BadRequest(400) from None
                if size == 0:
                    while await conn.read_line():
                        pass  # trailer fields
                    break
                if len(body) + size > MAX_BODY_BYTES:
                    raise _BadRequest(413)
                body += await conn.read_exactly(size)
                await conn.read_line()
            data = bytes(body)
        else:
            data = await conn.read_exactly(length) if length else b""
        return Request(method.upper(), target, headers, data, conn)

    async def _respond(self, conn: _Conn, request: Request) -> bool:
        """Run the request's handler and send its response; True when
        the connection stays open for another request."""
        handler = self._routes.get((request.method, request.path))
        if handler is None:
            status = (405 if any(p == request.path for _, p in self._routes)
                      else 404)
            return await self._send_whole(conn, _plain_error(status),
                                          conn.keep_alive)
        task = asyncio.ensure_future(handler(request))
        watcher = asyncio.ensure_future(conn.watch(task))
        try:
            resp = await task
        except asyncio.CancelledError:
            if task.cancelled() and not self._closing \
                    and asyncio.current_task().cancelling() == 0:
                return False  # the client went away
            raise
        except Exception:
            logger.exception("%s %s failed", request.method, request.path)
            resp = _plain_error(500)
        finally:
            watcher.cancel()
            try:
                await watcher
            except asyncio.CancelledError:
                pass
        if isinstance(resp, StreamResponse):
            if not resp.prepared:
                return await self._send_whole(conn, _plain_error(500),
                                              False)
            if not resp.eof:
                try:
                    await resp.write_eof()
                except (ConnectionError, OSError):
                    return False
            return conn.keep_alive and not self._closing
        return await self._send_whole(conn, resp, conn.keep_alive)

    async def _send_whole(self, conn: _Conn, resp: Response,
                          keep_alive: bool) -> bool:
        keep_alive = keep_alive and not conn.eof and not self._closing
        hdrs = {"Content-Type": resp.content_type,
                "Content-Length": str(len(resp.body)),
                **resp.headers,
                "Connection": "keep-alive" if keep_alive else "close"}
        try:
            await conn.send(_head_bytes(resp.status, hdrs) + resp.body)
        except (ConnectionError, OSError):
            return False
        return keep_alive


__all__ = [
    "Headers",
    "HttpServer",
    "Request",
    "Response",
    "StreamResponse",
    "json_response",
]
