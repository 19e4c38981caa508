"""TCP request plane: streaming RPC between frontend and workers.

A copy of dynamo_tpu/runtime/request_plane.py (its chaos seams left
out), with the same frames (`req`, `cancel`, `data`, `err`, `end`, codec.py)
and the same cancel/kill semantics, so a JAX frontend's client streams
from a torch worker's server and back.  Server side: one shared TCP
endpoint per process; registered handlers are async generators keyed by
"namespace/component/endpoint" and instance id.  Client side: pooled
connections per remote address, many in-flight streams multiplexed per
connection.

Cancellation: a `cancel` frame stops the handler's CancellationToken
(graceful) or kills it.
"""

from __future__ import annotations

import asyncio
import logging
import secrets
from typing import Any, AsyncIterator, Callable, Dict, Optional, Tuple

from . import aio
from .cancellation import CancellationToken
from .codec import read_frame, write_frame

logger = logging.getLogger(__name__)

# handler(payload, ctx) -> async iterator of stream items
Handler = Callable[[Any, "RequestContext"], AsyncIterator[Any]]


class RequestContext:
    """Per-request context passed to endpoint handlers."""

    def __init__(self, request_id: str, token: CancellationToken,
                 headers: Optional[Dict[str, Any]] = None):
        self.request_id = request_id
        self.token = token
        self.headers = headers or {}

    def is_stopped(self) -> bool:
        return self.token.is_stopped()


class RequestPlaneServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 root_token: Optional[CancellationToken] = None):
        self.host = host
        self.port = port
        # path -> instance_id -> handler.  Several instances of one endpoint
        # can share a process's server; requests carry the target iid.
        self._handlers: Dict[str, Dict[Optional[int], Handler]] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._root = root_token or CancellationToken()
        self.address: Optional[str] = None
        self._conn_tasks: set[asyncio.Task] = set()
        self._start_lock: Optional[asyncio.Lock] = None
        # on_activity(path, instance_id): every successfully streamed
        # response frame resets the endpoint's canary (health_check.py)
        self.on_activity = None

    def register_handler(self, path: str, handler: Handler,
                         instance_id: Optional[int] = None) -> None:
        self._handlers.setdefault(path, {})[instance_id] = handler

    def deregister_handler(self, path: str,
                           instance_id: Optional[int] = None) -> None:
        by_iid = self._handlers.get(path)
        if by_iid is None:
            return
        by_iid.pop(instance_id, None)
        if not by_iid:
            self._handlers.pop(path, None)

    def _resolve_handler(self, path: str,
                         instance_id: Optional[int]) -> Optional[Handler]:
        by_iid = self._handlers.get(path)
        if not by_iid:
            return None
        h = by_iid.get(instance_id)
        if h is not None:
            return h
        if len(by_iid) == 1:
            return next(iter(by_iid.values()))
        return None

    async def start(self) -> str:
        if self._start_lock is None:
            self._start_lock = asyncio.Lock()
        async with self._start_lock:
            if self._server is None:
                self._server = await asyncio.start_server(
                    self._on_connection, self.host, self.port
                )
                port = self._server.sockets[0].getsockname()[1]
                self.address = f"{self.host}:{port}"
        return self.address  # type: ignore

    async def close(self) -> None:
        self._root.kill()
        # cancel connection handlers first: py3.12 Server.wait_closed() blocks
        # until every connection callback returns
        for t in list(self._conn_tasks):
            t.cancel()
        if self._conn_tasks:
            await asyncio.gather(*self._conn_tasks, return_exceptions=True)
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def _on_connection(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        if task:
            self._conn_tasks.add(task)
        write_lock = asyncio.Lock()
        inflight: Dict[str, Tuple[asyncio.Task, CancellationToken]] = {}
        try:
            while True:
                try:
                    frame = await read_frame(reader)
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    break
                t = frame.get("t")
                if t == "req":
                    rid = frame["id"]
                    token = self._root.child()
                    hdl_task = asyncio.create_task(
                        self._run_handler(frame, writer, write_lock, token)
                    )
                    inflight[rid] = (hdl_task, token)
                    hdl_task.add_done_callback(
                        lambda _t, rid=rid: inflight.pop(rid, None)
                    )
                elif t == "cancel":
                    ent = inflight.get(frame["id"])
                    if ent is not None:
                        task_, token_ = ent
                        if frame.get("kill"):
                            token_.kill()
                            task_.cancel()
                        else:
                            token_.stop()
                else:
                    logger.warning("unknown frame type %r", t)
        finally:
            for task_, token_ in inflight.values():
                token_.kill()
                task_.cancel()
            writer.close()
            if task:
                self._conn_tasks.discard(task)

    async def _run_handler(self, frame: Dict[str, Any],
                           writer: asyncio.StreamWriter,
                           write_lock: asyncio.Lock,
                           token: CancellationToken) -> None:
        rid = frame["id"]
        path = frame.get("path", "")
        handler = self._resolve_handler(path, frame.get("iid"))

        async def send(obj: Dict[str, Any]) -> None:
            async with write_lock:
                await write_frame(writer, obj)

        if handler is None:
            await send({"t": "err", "id": rid,
                        "error": f"no handler for endpoint {path!r}"})
            return
        ctx = RequestContext(rid, token, frame.get("ctx"))
        try:
            async for item in handler(frame.get("payload"), ctx):
                await send({"t": "data", "id": rid, "data": item})
                if self.on_activity is not None:
                    self.on_activity(path, frame.get("iid"))
            await send({"t": "end", "id": rid})
        except asyncio.CancelledError:
            # always terminate the stream, even on kill — the client may be
            # draining and would otherwise hang forever
            try:
                await send({"t": "err", "id": rid, "error": "cancelled"})
            except (ConnectionResetError, RuntimeError, OSError):
                pass
        except Exception as e:  # handler bug or engine error -> stream error
            logger.exception("handler error on %s", path)
            try:
                await send({"t": "err", "id": rid, "error": f"{type(e).__name__}: {e}"})
            except (ConnectionResetError, RuntimeError):
                pass
        finally:
            token.detach()


class EngineError(Exception):
    """Remote handler raised; carries the remote error string.

    The Migration operator inspects these to decide retryability
    (ref: lib/llm/src/migration.rs:60-75).
    """


class _Connection:
    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self.write_lock = asyncio.Lock()
        self.streams: Dict[str, asyncio.Queue] = {}
        self.closed = False
        # abandoned-stream cancel frames in flight (stream()'s finally):
        # the loop only weak-refs tasks, so a fire-and-forget cancel
        # could be gc'd before the frame hits the wire (DYN005)
        self.bg_tasks: set = set()
        self._pump = asyncio.create_task(self._pump_loop())

    async def _pump_loop(self) -> None:
        try:
            while True:
                frame = await read_frame(self.reader)
                q = self.streams.get(frame.get("id"))
                if q is not None:
                    q.put_nowait(frame)
        except (asyncio.IncompleteReadError, ConnectionResetError, OSError):
            pass
        finally:
            self.closed = True
            for q in self.streams.values():
                q.put_nowait({"t": "err", "error": "connection lost"})

    async def close(self) -> None:
        self.closed = True
        self._pump.cancel()
        self.writer.close()


class RequestPlaneClient:
    """Pooled streaming client. One connection per remote address."""

    def __init__(self) -> None:
        self._conns: Dict[str, _Connection] = {}
        self._lock = asyncio.Lock()

    async def _get_conn(self, address: str) -> _Connection:
        async with self._lock:
            conn = self._conns.get(address)
            if conn is None or conn.closed:
                host, port = address.rsplit(":", 1)
                reader, writer = await asyncio.open_connection(host, int(port))
                conn = _Connection(reader, writer)
                self._conns[address] = conn
            return conn

    async def stream(
        self,
        address: str,
        path: str,
        payload: Any,
        ctx: Optional[Dict[str, Any]] = None,
        token: Optional[CancellationToken] = None,
        instance_id: Optional[int] = None,
    ) -> AsyncIterator[Any]:
        """Issue a request; yields stream items; raises EngineError on remote
        error.  If `token` stops/kills mid-stream, a cancel frame is sent; if
        the consumer abandons the stream (breaks out), the server is told to
        kill the handler so it doesn't generate for a dead consumer."""
        conn = await self._get_conn(address)
        rid = secrets.token_hex(8)
        q: asyncio.Queue = asyncio.Queue()
        conn.streams[rid] = q
        finished = False

        async def send_cancel(kill: bool) -> None:
            try:
                async with conn.write_lock:
                    await write_frame(
                        conn.writer, {"t": "cancel", "id": rid, "kill": kill}
                    )
            except (ConnectionResetError, OSError, RuntimeError):
                pass

        try:
            async with conn.write_lock:
                await write_frame(conn.writer, {
                    "t": "req", "id": rid, "path": path, "iid": instance_id,
                    "payload": payload, "ctx": ctx or {},
                })
            cancel_sent = False
            while True:
                if token is not None and token.is_stopped():
                    if not cancel_sent:
                        await send_cancel(token.is_killed())
                        cancel_sent = True
                    if token.is_killed():
                        finished = True
                        return
                    # graceful stop: drain until the server ends the stream
                    frame = await q.get()
                elif token is not None:
                    get = asyncio.ensure_future(q.get())
                    stop = asyncio.ensure_future(token.wait_stopped())
                    try:
                        done, _ = await asyncio.wait(
                            {get, stop}, return_when=asyncio.FIRST_COMPLETED
                        )
                    finally:
                        # also when the consumer itself is cancelled (a
                        # frontend whose HTTP client went away): neither
                        # waiter may outlive the stream
                        for p in (get, stop):
                            if not p.done():
                                p.cancel()
                    if get not in done:
                        continue
                    frame = get.result()
                else:
                    frame = await q.get()
                t = frame.get("t")
                if t == "data":
                    yield frame["data"]
                elif t == "end":
                    finished = True
                    return
                elif t == "err":
                    finished = True
                    raise EngineError(frame.get("error", "unknown remote error"))
        finally:
            conn.streams.pop(rid, None)
            if not finished and not conn.closed:
                # consumer broke out of the stream — stop the remote handler
                try:
                    aio.spawn_retained(send_cancel(True), conn.bg_tasks)
                except RuntimeError:
                    pass

    async def close(self) -> None:
        async with self._lock:
            for conn in self._conns.values():
                await conn.close()
            self._conns.clear()
