"""Event plane: pub/sub for KV events, load metrics and FPM records.

A copy of dynamo_tpu/runtime/event_plane.py whose payloads go through the
port's own msgpack codec (codec.py), byte for byte what the JAX module's
`msgpack` calls produce, so either package reads the other's events.

Backends:
  * InProcEventPlane — per-cluster in-process broadcast (module-global,
    so it never sees the JAX package's in-process bus).
  * ZmqEventPlane    — each publisher binds a PUB socket on an ephemeral
    port and announces it in discovery under v1/events/{instance_id};
    subscribers watch that prefix and connect SUB sockets with a topic
    filter.  Works across processes (and across the two packages) with no
    broker.  Needs pyzmq, imported inside the class: a machine without
    it raises ImportError when the zmq plane is asked for, and never
    falls back to the in-process bus (whose events no other process
    would see).

Subjects are dotted strings, e.g. "kv_events.{namespace}.{component}" —
a subscription matches subject prefixes.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, AsyncIterator, Dict, List, Optional, Tuple

from .aio import iter_queue
from .codec import packb, unpackb
from .discovery import EVENT_ENDPOINT_PREFIX, DiscoveryBackend, new_instance_id

logger = logging.getLogger(__name__)


class EventPlane:
    async def publish(self, subject: str, payload: Any) -> None:
        raise NotImplementedError

    def subscribe(
        self, subject_prefix: str, cancel: Optional[asyncio.Event] = None
    ) -> AsyncIterator[Tuple[str, Any]]:
        raise NotImplementedError

    async def close(self) -> None:
        pass


class _InProcBus:
    def __init__(self) -> None:
        self.subs: List[Tuple[str, asyncio.Queue]] = []


_BUSES: Dict[str, _InProcBus] = {}


class InProcEventPlane(EventPlane):
    def __init__(self, cluster_id: str = "default"):
        self._bus = _BUSES.setdefault(cluster_id, _InProcBus())

    async def publish(self, subject: str, payload: Any) -> None:
        for prefix, q in list(self._bus.subs):
            if subject.startswith(prefix):
                q.put_nowait((subject, payload))

    async def subscribe(
        self, subject_prefix: str, cancel: Optional[asyncio.Event] = None
    ) -> AsyncIterator[Tuple[str, Any]]:
        q: asyncio.Queue = asyncio.Queue()
        ent = (subject_prefix, q)
        self._bus.subs.append(ent)
        try:
            async for item in iter_queue(q, cancel):
                yield item
        finally:
            try:
                self._bus.subs.remove(ent)
            except ValueError:
                pass


class ZmqEventPlane(EventPlane):
    """Brokerless ZMQ pub/sub with discovery-announced publisher endpoints."""

    def __init__(self, discovery: DiscoveryBackend, host: str = "127.0.0.1"):
        try:
            import zmq
            import zmq.asyncio
        except ImportError as e:
            raise ImportError(
                "the zmq event plane needs pyzmq, which is not installed: "
                "install it, or run the whole deployment in one process "
                "with DYN_EVENT_PLANE=inproc") from e
        self._zmq = zmq
        self._ctx = zmq.asyncio.Context.instance()
        self.discovery = discovery
        self.host = host
        self._pub = None
        self._pub_addr: Optional[str] = None
        self._iid = new_instance_id()

    async def _ensure_pub(self) -> None:
        if self._pub is None:
            self._pub = self._ctx.socket(self._zmq.PUB)
            port = self._pub.bind_to_random_port(f"tcp://{self.host}")
            self._pub_addr = f"tcp://{self.host}:{port}"
            await self.discovery.put(
                f"{EVENT_ENDPOINT_PREFIX}/{self._iid}", {"address": self._pub_addr}
            )
            # PUB/SUB joins are async; give subscribers a beat to connect.
            await asyncio.sleep(0.05)

    async def publish(self, subject: str, payload: Any) -> None:
        await self._ensure_pub()
        assert self._pub is not None
        await self._pub.send_multipart([subject.encode(), packb(payload)])

    async def subscribe(
        self, subject_prefix: str, cancel: Optional[asyncio.Event] = None
    ) -> AsyncIterator[Tuple[str, Any]]:
        zmq = self._zmq
        sub = self._ctx.socket(zmq.SUB)
        sub.setsockopt(zmq.SUBSCRIBE, subject_prefix.encode())
        connected: set[str] = set()
        out_q: asyncio.Queue = asyncio.Queue()
        stop = asyncio.Event()

        async def watch_publishers() -> None:
            async for ev in self.discovery.watch(
                EVENT_ENDPOINT_PREFIX + "/", cancel=stop
            ):
                if ev.type == "put" and ev.value:
                    addr = ev.value.get("address")
                    if addr and addr not in connected:
                        sub.connect(addr)
                        connected.add(addr)

        async def recv_loop() -> None:
            while True:
                subject, body = await sub.recv_multipart()
                out_q.put_nowait((subject.decode(), unpackb(body)))

        wt = asyncio.create_task(watch_publishers())
        rt = asyncio.create_task(recv_loop())
        try:
            async for item in iter_queue(out_q, cancel):
                yield item
        finally:
            stop.set()
            wt.cancel()
            rt.cancel()
            sub.close(linger=0)

    async def close(self) -> None:
        if self._pub is not None:
            await self.discovery.delete(f"{EVENT_ENDPOINT_PREFIX}/{self._iid}")
            self._pub.close(linger=0)
            self._pub = None


def make_event_plane(kind: str, discovery: DiscoveryBackend,
                     cluster_id: str = "default",
                     host: str = "") -> EventPlane:
    if kind == "inproc":
        return InProcEventPlane(cluster_id)
    if kind == "zmq":
        # host is the ADVERTISED bind address: it must be reachable from
        # the other processes of the deployment
        return ZmqEventPlane(discovery, host=host or "127.0.0.1")
    raise ValueError(f"unknown event plane: {kind}")
