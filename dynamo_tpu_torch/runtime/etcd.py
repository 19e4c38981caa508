"""etcd discovery backend: lease-scoped KV with prefix watch over the
etcd v3 JSON gateway.

A copy of dynamo_tpu/runtime/etcd.py with the same key layout, base64
coding, lease discipline and watch semantics, so a torch worker and JAX
processes sharing one etcd see each other.  It speaks the grpc-gateway
JSON endpoints (`/v3/kv/*`, `/v3/lease/*`, `/v3/watch`) through the
port's standard-library client (runtime/http.py) where the JAX module
uses aiohttp:

  * one lease per backend instance, granted at start, kept alive at ttl/3
  * put(lease=True) binds the key to it; crash -> etcd expires the lease
    -> watchers see deletes (the failure-detection primitive); a
    keepalive that finds the lease expired (TTL 0) grants a fresh one and
    re-puts every owned key
  * watch = range snapshot (puts) + streaming watch from the snapshot
    revision; reconnects diff against the last known state so consumers
    never miss a delete across a gap

Select with DYN_DISCOVERY_BACKEND=etcd DYN_ETCD_ENDPOINT=http://host:2379.
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
from typing import Any, AsyncIterator, Dict, Optional

from .. import chaos
from .discovery import DiscoveryBackend, WatchEvent, diff_snapshot
from .http import HttpClient
from .retry import LEASE_POLICY, call_with_retry

logger = logging.getLogger(__name__)


def _b64(data: bytes) -> str:
    return base64.b64encode(data).decode()


def _unb64(s: str) -> bytes:
    return base64.b64decode(s)


def prefix_range_end(prefix: bytes) -> bytes:
    """etcd range_end for a prefix scan: prefix with its last byte
    incremented (carrying over 0xff bytes, per etcd semantics)."""
    b = bytearray(prefix)
    while b:
        if b[-1] < 0xFF:
            b[-1] += 1
            return bytes(b)
        b.pop()
    return b"\0"  # whole keyspace


class EtcdDiscovery(DiscoveryBackend):
    def __init__(self, endpoint: str = "http://127.0.0.1:2379",
                 ttl_s: float = 5.0):
        self.endpoint = endpoint.rstrip("/")
        self.ttl_s = max(ttl_s, 1.0)  # etcd grants integer-second TTLs
        self.lease_id: Optional[int] = None
        self._client = HttpClient(self.endpoint)
        self._ka_task: Optional[asyncio.Task] = None
        self._closed = asyncio.Event()
        self._start_lock = asyncio.Lock()
        # leased key -> last value, so an expired lease (partition longer
        # than TTL) can re-register everything under a fresh lease
        self._owned: Dict[str, Dict[str, Any]] = {}
        # health withdraw/restore (DiscoveryBackend base) reads this
        self._owned_values = self._owned

    # -- transport --------------------------------------------------------

    def _http(self) -> HttpClient:
        if self._closed.is_set():
            # a watch generator outliving close() must not keep calling
            # the gateway: fail its retry loop
            raise RuntimeError("EtcdDiscovery is closed")
        return self._client

    async def _call(self, path: str, body: Dict[str, Any]) -> Dict[str, Any]:
        return await self._http().call("POST", path, body)

    # -- lease ------------------------------------------------------------

    async def start(self) -> None:
        async with self._start_lock:  # concurrent first puts race here
            if self.lease_id is not None:
                return
            # a transient gateway outage at startup must not kill the
            # worker before it ever registers
            out = await call_with_retry(
                lambda: self._call("/v3/lease/grant",
                                   {"TTL": int(round(self.ttl_s)), "ID": 0}),
                LEASE_POLICY,
                on_retry=lambda n, e: logger.warning(
                    "etcd lease grant failed (attempt %d): %s", n, e),
            )
            self.lease_id = int(out["ID"])
            if self._ka_task is None:
                self._ka_task = asyncio.create_task(self._keepalive_loop())

    async def _keepalive_loop(self) -> None:
        """One keepalive POST per ttl/3.  The gateway answers TTL=0 for an
        expired lease: re-register then (a partition longer than the TTL
        otherwise leaves a healthy worker permanently invisible)."""
        interval = self.ttl_s / 3.0
        while not self._closed.is_set():
            try:
                await asyncio.wait_for(self._closed.wait(), timeout=interval)
                return
            except asyncio.TimeoutError:
                pass
            try:
                # chaos seam: fail = a missed keepalive (transient
                # outage); the loop's own retry-next-tick then covers
                # recovery, and a long enough outage expires the lease
                await chaos.ahit("discovery.lease", key=self.endpoint)
                body = await self._call("/v3/lease/keepalive",
                                        {"ID": self.lease_id})
                expired = int((body.get("result") or {}).get("TTL", 0)) <= 0
            except Exception as e:  # noqa: BLE001 — keepalive must survive
                logger.warning("etcd keepalive failed: %s", e)
                continue
            if expired:
                logger.warning("etcd lease %s expired; re-registering %d "
                               "keys under a fresh lease", self.lease_id,
                               len(self._owned))
                try:
                    await self._reregister()
                except Exception as e:  # noqa: BLE001 — retry next tick
                    logger.warning("etcd re-register failed: %s", e)

    async def _reregister(self) -> None:
        out = await call_with_retry(
            lambda: self._call("/v3/lease/grant",
                               {"TTL": int(round(self.ttl_s)), "ID": 0}),
            LEASE_POLICY,
        )
        self.lease_id = int(out["ID"])
        for key, value in list(self._owned.items()):
            body = {
                "key": _b64(key.encode()),
                "value": _b64(json.dumps(value).encode()),
                "lease": self.lease_id,
            }
            # per-key retry: one flaky put must not abort the whole
            # re-registration (the keepalive loop would restart it, but
            # each restart grants yet another lease)
            await call_with_retry(
                lambda body=body: self._call("/v3/kv/put", body),
                LEASE_POLICY,
            )

    # -- kv ---------------------------------------------------------------

    async def put(self, key: str, value: Dict[str, Any],
                  lease: bool = True) -> None:
        await chaos.ahit("discovery.op", key=f"put:{key}")
        await self.start()
        body = {
            "key": _b64(key.encode()),
            "value": _b64(json.dumps(value).encode()),
        }
        if lease:
            body["lease"] = self.lease_id
            self._owned[key] = value
        await self._call("/v3/kv/put", body)

    async def delete(self, key: str) -> None:
        await chaos.ahit("discovery.op", key=f"delete:{key}")
        self._owned.pop(key, None)
        self._forget_withdrawn(key)
        await self._call("/v3/kv/deleterange", {"key": _b64(key.encode())})

    async def _range(self, prefix: str):
        out = await self._call("/v3/kv/range", {
            "key": _b64(prefix.encode()),
            "range_end": _b64(prefix_range_end(prefix.encode())),
        })
        kvs = {}
        for kv in out.get("kvs", []) or []:
            try:
                kvs[_unb64(kv["key"]).decode()] = json.loads(
                    _unb64(kv.get("value", "")).decode() or "null")
            except (ValueError, KeyError):
                continue
        revision = int(out.get("header", {}).get("revision", 0))
        return kvs, revision

    async def get_prefix(self, prefix: str) -> Dict[str, Dict[str, Any]]:
        await chaos.ahit("discovery.op", key=f"get:{prefix}")
        kvs, _ = await self._range(prefix)
        return kvs

    # -- watch ------------------------------------------------------------

    async def watch(
        self, prefix: str, cancel: Optional[asyncio.Event] = None
    ) -> AsyncIterator[WatchEvent]:
        from .aio import iter_queue

        q: asyncio.Queue = asyncio.Queue()
        stop = asyncio.Event()
        known: Dict[str, str] = {}

        async def stream_loop() -> None:
            backoff = 0.1
            while not stop.is_set():
                try:
                    kvs, revision = await self._range(prefix)
                    # snapshot diff: puts for new/changed, deletes for
                    # keys that vanished during a stream gap
                    diff_snapshot(known, kvs, q.put_nowait)
                    body = {"create_request": {
                        "key": _b64(prefix.encode()),
                        "range_end": _b64(prefix_range_end(prefix.encode())),
                        "start_revision": revision + 1,
                    }}
                    # long-lived: no timeout once the stream is open
                    async with self._http().stream(
                            "POST", "/v3/watch", json=body) as lines:
                        backoff = 0.1
                        async for line in lines:
                            if stop.is_set():
                                return
                            line = line.strip()
                            if not line:
                                continue
                            self._handle_watch_chunk(line, known, q)
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001 — reconnect
                    if stop.is_set() or self._closed.is_set():
                        return
                    logger.warning("etcd watch stream error (%s); "
                                   "reconnecting in %.1fs", e, backoff)
                    await asyncio.sleep(backoff)
                    backoff = min(backoff * 2, 5.0)

        task = asyncio.create_task(stream_loop())
        try:
            async for ev in iter_queue(q, cancel):
                yield ev
        finally:
            stop.set()
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)

    @staticmethod
    def _handle_watch_chunk(line: bytes, known: Dict[str, str],
                            q: asyncio.Queue) -> None:
        try:
            msg = json.loads(line)
        except ValueError:
            return
        result = msg.get("result") or {}
        for ev in result.get("events", []) or []:
            kv = ev.get("kv") or {}
            try:
                key = _unb64(kv["key"]).decode()
            except (KeyError, ValueError):
                continue
            if ev.get("type") == "DELETE":
                known.pop(key, None)
                q.put_nowait(WatchEvent("delete", key))
            else:  # PUT (etcd omits the type for PUT, its zero value)
                try:
                    value = json.loads(_unb64(kv.get("value", "")).decode())
                except ValueError:
                    continue
                known[key] = json.dumps(value, sort_keys=True)
                q.put_nowait(WatchEvent("put", key, value))

    # -- lifecycle --------------------------------------------------------

    async def revoke_lease(self) -> None:
        if self.lease_id is not None:
            try:
                await self._call("/v3/lease/revoke", {"ID": self.lease_id})
            except Exception as e:  # noqa: BLE001 — best-effort on shutdown
                logger.warning("etcd lease revoke failed: %s", e)
            self.lease_id = None
        self._owned.clear()

    async def close(self) -> None:
        if self._ka_task is not None:
            self._ka_task.cancel()
            self._ka_task = None
        # revoke BEFORE flagging closed: _http() refuses calls once
        # _closed is set, and the revoke is the last legitimate call
        await self.revoke_lease()
        self._closed.set()
        await self._client.close()
