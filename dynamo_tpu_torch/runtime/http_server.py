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
  * routes by method (GET, POST, DELETE) and path, where a path may hold
    `{name}` segments matched as aiohttp's resource routes match them
    (one segment, no `/`) and read back from `request.match_info`;
  * streamed request bodies for routes added with `stream=True`: the
    handler reads the body as it arrives (`request.content.read`,
    `request.multipart()`, a multipart/form-data reader whose parts
    yield bounded chunks, as aiohttp's `BodyPartReader.read_chunk`), so
    an upload is never held whole in memory; `request.json()` there
    still reads at most 1 MiB;
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
registered with `add_get` / `add_post` / `add_delete`.
"""

from __future__ import annotations

import asyncio
import json as _json
import logging
import re
from collections.abc import Mapping
from http import HTTPStatus
from typing import (
    AsyncIterator,
    Awaitable,
    Callable,
    Dict,
    Iterator,
    List,
    Optional,
    Tuple,
    Union,
)
from urllib.parse import parse_qs, unquote, urlsplit

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


class HttpError(Exception):
    """Raised inside a handler to answer with aiohttp's plain-text error
    for `status` (a streamed body past the size cap: 413)."""

    def __init__(self, status: int):
        super().__init__(status)
        self.status = status


class Request:
    """One request: method, path, query (first value per key), headers,
    the route's path parameters (`match_info`) and the body: whole in
    `body`, or, on a route added with `stream=True`, read from `content`
    as it arrives."""

    def __init__(self, method: str, target: str, headers: Headers,
                 body: bytes, conn: "_Conn"):
        self.method = method
        parts = urlsplit(target)
        self.path = parts.path
        self.query = {k: v[0] for k, v in
                      parse_qs(parts.query, keep_blank_values=True).items()}
        self.headers = headers
        self.body = body
        self.match_info: Dict[str, str] = {}
        self.content: Optional[_BodyReader] = None
        self._conn = conn
        self._path_known = False  # some route has this path (405, not 404)

    @property
    def content_type(self) -> str:
        """The media type of the body, parameters aside (aiohttp's)."""
        return self.headers.get("content-type", "").split(";", 1)[0] \
            .strip().lower()

    async def read(self) -> bytes:
        """The whole body (a streamed one up to MAX_BODY_BYTES: HttpError
        413 past it)."""
        if self.content is not None:
            data = bytearray()
            while True:
                chunk = await self.content.read(_READ_SIZE)
                if not chunk:
                    break
                data += chunk
                if len(data) > MAX_BODY_BYTES:
                    raise HttpError(413)
            self.body, self.content = bytes(data), None
        return self.body

    async def text(self) -> str:
        return (await self.read()).decode("utf-8")

    async def json(self):
        """The body as JSON; json.JSONDecodeError when it is not."""
        return _json.loads(await self.text())

    async def multipart(self) -> "MultipartReader":
        """A multipart/form-data reader over the streamed body."""
        m = re.search(r'boundary="?([^";]+)"?',
                      self.headers.get("content-type", ""))
        if m is None or self.content is None:
            raise HttpError(400)
        return MultipartReader(self.content, m.group(1).encode("latin-1"))


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


class _BodyReader:
    """A request body read from its connection as it arrives, framed by
    Content-Length or chunked transfer coding; `read` gives b"" at its
    end and raises ConnectionError when the client goes away first."""

    def __init__(self, conn: "_Conn", length: int, chunked: bool):
        self._conn = conn
        self._left = length       # bytes of the body (or of the chunk)
        self._chunked = chunked
        self.done = not chunked and length == 0

    async def _fill(self) -> None:
        await asyncio.wait_for(self._conn._fill(), BODY_TIMEOUT_S)

    async def read(self, n: int = _READ_SIZE) -> bytes:
        conn = self._conn
        if self.done:
            return b""
        if self._chunked and self._left == 0:
            line = await asyncio.wait_for(conn.read_line(), BODY_TIMEOUT_S)
            try:
                size = int(line.split(b";", 1)[0].strip(), 16)
            except ValueError:
                raise ConnectionError("malformed chunked body") from None
            if size == 0:
                while await asyncio.wait_for(conn.read_line(),
                                             BODY_TIMEOUT_S):
                    pass  # trailer fields
                self.done = True
                return b""
            self._left = size
        if not conn.buf:
            await self._fill()
        k = min(n, self._left, len(conn.buf))
        data = bytes(conn.buf[:k])
        del conn.buf[:k]
        self._left -= k
        if self._left == 0:
            if self._chunked:
                await asyncio.wait_for(conn.read_line(), BODY_TIMEOUT_S)
            else:
                self.done = True
        return data


class BodyPart:
    """One part of a multipart/form-data body: `name` and `filename`
    from its Content-Disposition, `headers`, and `read_chunk`, which
    gives the part's bytes in chunks of at most `size` and b"" at its
    end."""

    def __init__(self, reader: "MultipartReader", headers: Headers):
        self._reader = reader
        self.headers = headers
        disp = headers.get("content-disposition", "")
        params = dict(
            (k.lower(), v) for k, v in re.findall(
                r';\s*([\w*-]+)="?((?<=")[^"]*|[^";]*)"?', disp))
        self.name: Optional[str] = params.get("name")
        self.filename: Optional[str] = params.get("filename")
        self.at_eof = False

    async def read_chunk(self, size: int = 8192) -> bytes:
        if self.at_eof:
            return b""
        data = await self._reader._part_bytes(size)
        if not data:
            self.at_eof = True
        return data


class MultipartReader:
    """multipart/form-data over a streamed body (RFC 7578): `async for
    part in reader` yields each BodyPart in order; a part not read to its
    end is skipped when the next is asked for.  Only a delimiter's length
    of bytes is held back while a part streams.  A body that ends before
    its closing delimiter raises ValueError."""

    def __init__(self, content: _BodyReader, boundary: bytes):
        self._content = content
        self._dash = b"--" + boundary
        self._delim = b"\r\n" + self._dash
        self._buf = bytearray()
        self._part: Optional[BodyPart] = None
        self._started = False
        self._closed = False

    async def _more(self) -> None:
        data = await self._content.read(_READ_SIZE)
        if not data:
            raise ValueError("multipart body ended before its closing "
                             "delimiter")
        self._buf += data

    async def _part_bytes(self, size: int) -> bytes:
        """Up to `size` bytes of the open part; b"" at its delimiter,
        which is consumed."""
        while True:
            i = self._buf.find(self._delim)
            if i == 0:
                del self._buf[:len(self._delim)]
                return b""
            safe = i if i > 0 else len(self._buf) - len(self._delim) + 1
            if safe > 0:
                k = min(size, safe)
                data = bytes(self._buf[:k])
                del self._buf[:k]
                return data
            await self._more()

    async def _line(self) -> bytes:
        while True:
            i = self._buf.find(b"\r\n")
            if i >= 0:
                line = bytes(self._buf[:i])
                del self._buf[:i + 2]
                return line
            if len(self._buf) > MAX_HEAD_BYTES:
                raise ValueError("multipart part head too long")
            await self._more()

    def __aiter__(self) -> AsyncIterator[BodyPart]:
        return self

    async def __anext__(self) -> BodyPart:
        if self._closed:
            raise StopAsyncIteration
        if not self._started:
            # the preamble up to the first delimiter line
            self._started = True
            while True:
                line = await self._line()
                if line.rstrip() == self._dash:
                    break
                if line.rstrip() == self._dash + b"--":
                    self._closed = True
                    raise StopAsyncIteration
        else:
            part = self._part
            while part is not None and await part.read_chunk(_READ_SIZE):
                pass
            # after a delimiter: "--" closes the body, CRLF opens a part
            while len(self._buf) < 2:
                await self._more()
            if self._buf[:2] == b"--":
                self._closed = True
                raise StopAsyncIteration
            await self._line()
        items: List[Tuple[str, str]] = []
        while True:
            line = await self._line()
            if not line:
                break
            k, _, v = line.decode("latin-1").partition(":")
            items.append((k.strip(), v.strip()))
        self._part = BodyPart(self, Headers(items))
        return self._part


_PARAM_RE = re.compile(r"\{(\w+)\}")


class _Route:
    """A path, exact or with `{name}` segments (each one path segment,
    as aiohttp's dynamic resources match them)."""

    def __init__(self, method: str, path: str, handler: Handler,
                 stream: bool):
        self.method = method
        self.path = path
        self.handler = handler
        self.stream = stream
        self.dynamic = bool(_PARAM_RE.search(path))
        parts = _PARAM_RE.split(path)
        rx = ""
        for i, piece in enumerate(parts):
            rx += (f"(?P<{piece}>[^{{}}/]+)" if i % 2 else re.escape(piece))
        self._rx = re.compile(rx + r"\Z")

    def match(self, path: str) -> Optional[Dict[str, str]]:
        if not self.dynamic:
            return {} if path == self.path else None
        m = self._rx.match(path)
        if m is None:
            return None
        return {k: unquote(v) for k, v in m.groupdict().items()}


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
    """Routes (method, path) to handlers, exact paths first, then paths
    with `{name}` segments in the order added; `start` binds `host:port`
    (port 0 picks a free one, read back from `bound_port`)."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0):
        self.host = host
        self.port = port
        self.bound_port: Optional[int] = None
        self._routes: Dict[Tuple[str, str], _Route] = {}
        self._dynamic: List[_Route] = []
        self._server: Optional[asyncio.AbstractServer] = None
        self._conn_tasks: set = set()
        self._closing = False

    def add_route(self, method: str, path: str, handler: Handler,
                  stream: bool = False) -> None:
        """`stream`: the handler reads the body itself, as it arrives
        (`request.content`, `request.multipart()`)."""
        route = _Route(method.upper(), path, handler, stream)
        if route.dynamic:
            self._dynamic.append(route)
        else:
            self._routes[(route.method, path)] = route

    def add_get(self, path: str, handler: Handler) -> None:
        self.add_route("GET", path, handler)

    def add_post(self, path: str, handler: Handler,
                 stream: bool = False) -> None:
        self.add_route("POST", path, handler, stream)

    def add_delete(self, path: str, handler: Handler) -> None:
        self.add_route("DELETE", path, handler)

    def _resolve(self, method: str, path: str
                 ) -> Tuple[Optional[_Route], Dict[str, str], bool]:
        """(the route, its path parameters, whether any route has the
        path under another method)."""
        route = self._routes.get((method, path))
        if route is not None:
            return route, {}, True
        known = any(p == path for _, p in self._routes)
        for r in self._dynamic:
            params = r.match(path)
            if params is None:
                continue
            if r.method == method:
                return r, params, True
            known = True
        return None, {}, known

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
                    request, route = await asyncio.wait_for(
                        self._parse(conn, head), BODY_TIMEOUT_S)
                except _BadRequest as e:
                    await self._send_whole(conn, _plain_error(e.status),
                                           False)
                    return
                except (asyncio.TimeoutError, ConnectionError, OSError,
                        asyncio.IncompleteReadError):
                    return
                if not await self._respond(conn, request, route):
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

    async def _parse(self, conn: _Conn, head: bytes
                     ) -> Tuple[Request, Optional[_Route]]:
        """The request and its route.  The body is read whole here
        (413 past MAX_BODY_BYTES), unless the route streams it."""
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
        request = Request(method.upper(), target, headers, b"", conn)
        route, params, known = self._resolve(request.method, request.path)
        request.match_info = params
        request._path_known = known
        stream = route is not None and route.stream
        if length > MAX_BODY_BYTES and not stream:
            raise _BadRequest(413)
        if (chunked or length) and headers.get(
                "expect", "").lower() == "100-continue":
            await conn.send(b"HTTP/1.1 100 Continue\r\n\r\n")
        if stream:
            request.content = _BodyReader(conn, 0 if chunked else length,
                                          chunked)
            return request, route
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
        request.body = data
        return request, route

    async def _respond(self, conn: _Conn, request: Request,
                       route: Optional[_Route]) -> bool:
        """Run the request's handler and send its response; True when
        the connection stays open for another request."""
        if route is None:
            status = 405 if request._path_known else 404
            return await self._send_whole(conn, _plain_error(status),
                                          conn.keep_alive)
        task = asyncio.ensure_future(route.handler(request))
        # a streamed body is read by the handler itself, which sees the
        # client's going away as a failed read: no read-ahead watcher
        watcher = (asyncio.ensure_future(conn.watch(task))
                   if request.content is None else None)
        try:
            resp = await task
        except asyncio.CancelledError:
            if task.cancelled() and not self._closing \
                    and asyncio.current_task().cancelling() == 0:
                return False  # the client went away
            raise
        except HttpError as e:
            resp = _plain_error(e.status)
            conn.keep_alive = False
        except (ConnectionError, OSError, asyncio.TimeoutError):
            if request.content is not None:
                return False  # the client went away mid-body
            logger.exception("%s %s failed", request.method, request.path)
            resp = _plain_error(500)
        except Exception:
            logger.exception("%s %s failed", request.method, request.path)
            resp = _plain_error(500)
        finally:
            if watcher is not None:
                watcher.cancel()
                try:
                    await watcher
                except asyncio.CancelledError:
                    pass
        if request.content is not None and not request.content.done:
            # the handler answered before the body's end: the rest of it
            # would be read as the next request, so the connection ends
            conn.keep_alive = False
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
    "BodyPart",
    "Headers",
    "HttpError",
    "HttpServer",
    "MultipartReader",
    "Request",
    "Response",
    "StreamResponse",
    "json_response",
]
