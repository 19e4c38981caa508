"""A small asyncio HTTP/1.1 client on the standard library.

The etcd and kubernetes discovery backends (runtime/etcd.py,
runtime/kube.py) speak JSON over HTTP to the etcd v3 gateway and the
Kubernetes API server.  The JAX package's backends use aiohttp, which
the machines the port serves on do not have; runtime/system_status.py
is the server side of the same choice.  This client gives them what
they use of aiohttp, and nothing more:

  * JSON request bodies and JSON responses, query parameters, a bearer
    token, and TLS verified against a CA file for the in-cluster API
    server (`ssl.create_default_context(cafile=...)`, resolved by
    runtime/kube.py), or the system trust store without one;
  * `Content-Length` bodies, chunked transfer coding and bodies that
    end with the connection;
  * a timeout over a whole request (`DEFAULT_TIMEOUT_S`, 30 s, as
    the JAX backends' sessions have);
  * streams (`stream`) for the watch endpoints: no timeout once the
    response head is in, unless the caller gives a `read_timeout` for
    each read, and lines yielded whole, whether the server split one
    line across several chunks or packed several into one;
  * raw responses (`open_raw`) for a proxy (the port's global router):
    a bytes body and the caller's headers sent as they are, the status
    and headers whatever the status, and the body's bytes chunk by
    chunk as they arrive (aiohttp's `iter_any`), with a bound on the
    connect alone.

One request per connection (`Connection: close`): discovery calls are
control-plane traffic, a few a second.  `close()` closes the sockets of
the streams still open, so a reader parked on one wakes with
ConnectionError instead of waiting forever; the client starts no task
of its own.
"""

from __future__ import annotations

import asyncio
import contextlib
import json as _json
import ssl as _ssl
from dataclasses import dataclass
from typing import Any, AsyncIterator, Dict, Optional, Tuple
from urllib.parse import urlencode, urlsplit

DEFAULT_TIMEOUT_S = 30.0
_READ_SIZE = 65536


class HttpError(Exception):
    """A response with a status of 400 or above."""

    def __init__(self, status: int, reason: str, body: bytes = b""):
        super().__init__(f"HTTP {status} {reason}: {body[:200]!r}")
        self.status = status
        self.reason = reason
        self.body = body


@dataclass
class Response:
    status: int
    reason: str
    headers: Dict[str, str]  # lower-case names
    body: bytes

    def json(self) -> Any:
        return _json.loads(self.body or b"null")

    def raise_for_status(self) -> None:
        if self.status >= 400:
            raise HttpError(self.status, self.reason, self.body)


async def _read_head(reader: asyncio.StreamReader
                     ) -> Tuple[int, str, Dict[str, str]]:
    """The status line and headers of one response (a 100 Continue
    interim response is skipped)."""
    while True:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except asyncio.IncompleteReadError as e:
            raise ConnectionError(
                "connection closed before the response head") from e
        lines = head.decode("latin-1").split("\r\n")
        parts = lines[0].split(" ", 2)
        if len(parts) < 2 or not parts[0].startswith("HTTP/"):
            raise ConnectionError(f"malformed status line {lines[0]!r}")
        status = int(parts[1])
        headers: Dict[str, str] = {}
        for line in lines[1:]:
            if ":" in line:
                name, _, value = line.partition(":")
                headers[name.strip().lower()] = value.strip()
        if status != 100:
            return status, (parts[2] if len(parts) > 2 else ""), headers


async def _within(aw, timeout: Optional[float]):
    return await (aw if timeout is None else asyncio.wait_for(aw, timeout))


async def _body_chunks(reader: asyncio.StreamReader, headers: Dict[str, str],
                       read_timeout: Optional[float] = None
                       ) -> AsyncIterator[bytes]:
    """The response body as it arrives: chunked transfer coding decoded,
    a Content-Length body read to its length, anything else read until
    the connection ends.  Each read waits at most `read_timeout`."""
    try:
        if "chunked" in headers.get("transfer-encoding", "").lower():
            while True:
                line = await _within(reader.readline(), read_timeout)
                if not line:
                    raise ConnectionError("stream closed mid-body")
                size = int(line.split(b";", 1)[0].strip(), 16)
                if size == 0:
                    # the trailer section ends with an empty line
                    while (await _within(reader.readline(), read_timeout)
                           ).strip():
                        pass
                    return
                data = await _within(reader.readexactly(size + 2),
                                     read_timeout)
                yield data[:-2]
        elif "content-length" in headers:
            left = int(headers["content-length"])
            while left > 0:
                data = await _within(reader.read(min(left, _READ_SIZE)),
                                     read_timeout)
                if not data:
                    raise ConnectionError("stream closed mid-body")
                left -= len(data)
                yield data
        else:
            while True:
                data = await _within(reader.read(_READ_SIZE), read_timeout)
                if not data:
                    return
                yield data
    except asyncio.IncompleteReadError as e:
        raise ConnectionError("stream closed mid-chunk") from e


async def iter_lines(chunks: AsyncIterator[bytes]) -> AsyncIterator[bytes]:
    """Whole lines (each with its b"\\n") from body chunks, whatever the
    chunk boundaries; a last line without a newline is yielded at the
    end of the body."""
    buf = b""
    async for chunk in chunks:
        buf += chunk
        while True:
            i = buf.find(b"\n")
            if i < 0:
                break
            yield buf[: i + 1]
            buf = buf[i + 1:]
    if buf:
        yield buf


class HttpClient:
    """Requests to one server (`base_url`: scheme, host, port and an
    optional path prefix).  `token` is sent as `Authorization: Bearer`;
    `ssl_context` verifies an https server (None: the system trust
    store)."""

    def __init__(self, base_url: str, *, token: str = "",
                 ssl_context: Optional[_ssl.SSLContext] = None):
        parts = urlsplit(base_url)
        if parts.scheme not in ("http", "https") or not parts.hostname:
            raise ValueError(f"unsupported URL {base_url!r}: expected "
                             "http://host[:port] or https://host[:port]")
        self.https = parts.scheme == "https"
        self.host = parts.hostname
        self.port = parts.port or (443 if self.https else 80)
        self.netloc = parts.netloc
        self.prefix = parts.path.rstrip("/")
        self.token = token
        self.ssl_context = ssl_context
        self.closed = False
        self._streams: set = set()  # writers of the open streams

    async def _send(self, method: str, path: str, body: Any,
                    params: Optional[Dict[str, str]],
                    headers: Optional[Dict[str, str]],
                    data: Optional[bytes] = None,
                    connect_timeout: Optional[float] = None):
        """Open a connection (within `connect_timeout`), send one request
        (`data` as it is, else `body` as JSON), read the response head.
        Returns (reader, writer, status, reason, headers)."""
        if self.closed:
            raise RuntimeError("HttpClient is closed")
        ssl = None
        if self.https:
            ssl = self.ssl_context or _ssl.create_default_context()
        reader, writer = await _within(asyncio.open_connection(
            self.host, self.port, ssl=ssl,
            server_hostname=self.host if ssl is not None else None),
            connect_timeout)
        try:
            if data is None:
                data = b"" if body is None else _json.dumps(body).encode()
            target = self.prefix + path
            if params:
                target += "?" + urlencode(params)
            hdrs = {"Host": self.netloc, "Accept": "application/json",
                    "Connection": "close",
                    "Content-Length": str(len(data))}
            if body is not None:
                hdrs["Content-Type"] = "application/json"
            if self.token:
                hdrs["Authorization"] = f"Bearer {self.token}"
            for k, v in (headers or {}).items():
                # the caller's value replaces ours whatever its case
                for mine in [m for m in hdrs if m.lower() == k.lower()]:
                    del hdrs[mine]
                hdrs[k] = v
            head = f"{method} {target} HTTP/1.1\r\n" + "".join(
                f"{k}: {v}\r\n" for k, v in hdrs.items()) + "\r\n"
            writer.write(head.encode("latin-1") + data)
            await writer.drain()
            status, reason, rhdrs = await _read_head(reader)
        except BaseException:
            writer.close()
            raise
        return reader, writer, status, reason, rhdrs

    async def _request(self, method, path, body, params, headers) -> Response:
        reader, writer, status, reason, rhdrs = await self._send(
            method, path, body, params, headers)
        try:
            data = b"".join([c async for c in _body_chunks(reader, rhdrs)])
        finally:
            writer.close()
        with contextlib.suppress(OSError):
            await writer.wait_closed()
        return Response(status, reason, rhdrs, data)

    async def request(self, method: str, path: str, *, json: Any = None,
                      params: Optional[Dict[str, str]] = None,
                      headers: Optional[Dict[str, str]] = None
                      ) -> Response:
        """One request, the whole of it (connect, send, read the body)
        within DEFAULT_TIMEOUT_S; raises asyncio.TimeoutError past it."""
        return await asyncio.wait_for(
            self._request(method, path, json, params, headers),
            DEFAULT_TIMEOUT_S)

    async def call(self, method: str, path: str, json: Any = None,
                   **kw) -> Any:
        """request() that raises HttpError on a status >= 400 and returns
        the decoded JSON body."""
        resp = await self.request(method, path, json=json, **kw)
        resp.raise_for_status()
        return resp.json()

    @contextlib.asynccontextmanager
    async def stream(self, method: str, path: str, *, json: Any = None,
                     params: Optional[Dict[str, str]] = None,
                     read_timeout: Optional[float] = None):
        """A streamed response as an async iterator of whole lines.  The
        connection and the response head are bounded by
        DEFAULT_TIMEOUT_S; after that each read waits at most `read_timeout`
        (None: no limit).  Raises HttpError on a status >= 400 before
        yielding."""
        reader, writer, status, reason, rhdrs = await asyncio.wait_for(
            self._send(method, path, json, params, None), DEFAULT_TIMEOUT_S)
        self._streams.add(writer)
        try:
            if status >= 400:
                body = b"".join([c async for c in _body_chunks(
                    reader, rhdrs, DEFAULT_TIMEOUT_S)])
                raise HttpError(status, reason, body)
            yield iter_lines(_body_chunks(reader, rhdrs, read_timeout))
        finally:
            self._streams.discard(writer)
            writer.close()

    @contextlib.asynccontextmanager
    async def open_raw(self, method: str, path: str, *, data: bytes,
                       headers: Dict[str, str],
                       connect_timeout: Optional[float] = None):
        """One request whose response is read as it arrives, whatever its
        status: yields (status, headers, chunks), `chunks` an async
        iterator of the body's bytes (chunked transfer coding decoded)
        in the pieces they arrived in.  `data` and `headers` are sent as
        given (Host, Content-Length and Connection are the client's);
        only the connect is bounded (`connect_timeout`)."""
        reader, writer, status, _reason, rhdrs = await self._send(
            method, path, None, None, headers, data=data,
            connect_timeout=connect_timeout)
        self._streams.add(writer)
        try:
            yield status, rhdrs, _body_chunks(reader, rhdrs)
        finally:
            self._streams.discard(writer)
            writer.close()

    async def close(self) -> None:
        """Refuse new requests and close the open streams' connections:
        their readers see the stream end (ConnectionError)."""
        self.closed = True
        for writer in list(self._streams):
            writer.close()
        self._streams.clear()


__all__ = ["HttpClient", "HttpError", "Response", "iter_lines"]
