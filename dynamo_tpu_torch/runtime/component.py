"""Namespace → Component → Endpoint hierarchy + endpoint clients.

A copy of dynamo_tpu/runtime/component.py.  `Endpoint.serve_endpoint(handler)`
registers a streaming handler on the process's request-plane server and
writes a lease-bound discovery entry (advertising the process's
system-status address as `system_addr` when it serves one);
`Endpoint.client()` watches discovery and routes requests to live
instances via a PushRouter in one of its modes.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, AsyncIterator, Dict, Optional

from .. import chaos
from .cancellation import CancellationToken
from .discovery import INSTANCE_PREFIX, Instance, WatchEvent, new_instance_id
from .push_router import PushRouter, RouterMode
from .request_plane import Handler

logger = logging.getLogger(__name__)


class Namespace:
    def __init__(self, runtime: "DistributedRuntime", name: str):  # noqa: F821
        self.runtime = runtime
        self.name = name

    def component(self, name: str) -> "Component":
        return Component(self, name)


class Component:
    def __init__(self, namespace: Namespace, name: str):
        self.namespace = namespace
        self.name = name

    @property
    def runtime(self) -> "DistributedRuntime":  # noqa: F821
        return self.namespace.runtime

    def endpoint(self, name: str) -> "Endpoint":
        return Endpoint(self, name)

    @property
    def path(self) -> str:
        return f"{self.namespace.name}/{self.name}"


class ServedEndpoint:
    def __init__(self, endpoint: "Endpoint", instance: Instance):
        self.endpoint = endpoint
        self.instance = instance

    @property
    def instance_id(self) -> int:
        return self.instance.instance_id

    async def shutdown(self) -> None:
        rt = self.endpoint.runtime
        await rt.system_health.deregister_target(
            self.endpoint.path, self.instance.instance_id)
        await rt.discovery.delete(self.instance.key())
        rt.request_server.deregister_handler(
            self.endpoint.path, self.instance.instance_id
        )


class Endpoint:
    def __init__(self, component: Component, name: str):
        self.component = component
        self.name = name

    @property
    def runtime(self) -> "DistributedRuntime":  # noqa: F821
        return self.component.runtime

    @property
    def path(self) -> str:
        return f"{self.component.path}/{self.name}"

    async def serve_endpoint(
        self,
        handler: Handler,
        metadata: Optional[Dict[str, Any]] = None,
        instance_id: Optional[int] = None,
        health_check_payload: Optional[Dict[str, Any]] = None,
    ) -> ServedEndpoint:
        """Register `handler` (async generator fn) and announce the instance.

        `health_check_payload` arms a canary for the endpoint: after
        DYN_CANARY_WAIT_S of inactivity the payload (with a fresh
        request_id) is run through the handler; failure marks the process
        unhealthy and withdraws its discovery lease (health_check.py)."""
        rt = self.runtime
        address = await rt.request_server.start()
        iid = instance_id if instance_id is not None else new_instance_id()
        meta = dict(metadata or {})
        # fleet introspection: every instance advertises where its
        # /metrics and /debug/state surface lives, so the aggregator
        # needs no out-of-band port map
        if rt.system_address and "system_addr" not in meta:
            meta["system_addr"] = rt.system_address
        instance = Instance(
            namespace=self.component.namespace.name,
            component=self.component.name,
            endpoint=self.name,
            instance_id=iid,
            address=address,
            metadata=meta,
        )
        rt.request_server.register_handler(self.path, handler, iid)
        if health_check_payload is not None:
            rt.system_health.register_target(self.path, iid,
                                             health_check_payload)
        await rt.discovery.put(instance.key(), instance.to_dict())
        logger.info("serving endpoint %s as instance %d @ %s",
                    self.path, iid, address)
        return ServedEndpoint(self, instance)

    def client(self, router_mode: RouterMode | str = RouterMode.ROUND_ROBIN) -> "Client":
        return Client(self, router_mode)


class Client:
    """Watches discovery for instances of one endpoint and routes to them."""

    def __init__(self, endpoint: Endpoint,
                 router_mode: RouterMode | str = RouterMode.ROUND_ROBIN):
        self.endpoint = endpoint
        self.router = PushRouter(RouterMode(router_mode))
        self._instances: Dict[int, Instance] = {}
        self._have_instances = asyncio.Event()
        self._cancel = asyncio.Event()
        self._watch_task: Optional[asyncio.Task] = None

    @property
    def runtime(self):
        return self.endpoint.runtime

    @property
    def instances(self) -> list[Instance]:
        return list(self._instances.values())

    @property
    def instance_ids(self) -> list[int]:
        return list(self._instances.keys())

    async def start(self) -> "Client":
        if self._watch_task is None:
            self._watch_task = asyncio.create_task(self._watch_loop())
        return self

    async def _watch_loop(self) -> None:
        prefix = f"{INSTANCE_PREFIX}/{self.endpoint.path}/"
        disco = self.runtime.discovery
        try:
            async for ev in disco.watch(prefix, cancel=self._cancel):
                self._apply(ev)
        except asyncio.CancelledError:
            pass

    def _apply(self, ev: WatchEvent) -> None:
        if ev.type == "put" and ev.value is not None:
            inst = Instance.from_dict(ev.value)
            self._instances[inst.instance_id] = inst
            self._have_instances.set()
        elif ev.type == "delete":
            try:
                iid = int(ev.key.rsplit("/", 1)[1])
            except (IndexError, ValueError):
                return
            self._instances.pop(iid, None)
            if not self._instances:
                self._have_instances.clear()

    async def wait_for_instances(self, timeout: float = 10.0) -> list[Instance]:
        await self.start()
        await asyncio.wait_for(self._have_instances.wait(), timeout)
        return self.instances

    async def generate(
        self,
        payload: Any,
        *,
        instance_id: Optional[int] = None,
        token: Optional[CancellationToken] = None,
        ctx: Optional[Dict[str, Any]] = None,
        on_pick=None,
        avoid=(),
    ) -> AsyncIterator[Any]:
        """Route a request and yield the response stream.  `on_pick` is
        told the chosen instance id (request tracing needs the placement
        even when this client's own router decides it).  `avoid` holds
        instance ids that already failed this request (migration): the
        built-in router skips them while any alternative exists — a
        replay must not land back on the worker that just died while the
        discovery watch is still converging."""
        if not self._instances:
            await self.wait_for_instances()
        if instance_id is not None:
            inst = self._instances.get(instance_id)
            if inst is None:
                raise RuntimeError(f"instance {instance_id} not found for {self.endpoint.path}")
        else:
            candidates = self.instances
            if avoid:
                filtered = [i for i in candidates
                            if i.instance_id not in avoid]
                if filtered:
                    candidates = filtered
            inst = self.router.pick(candidates)
        if on_pick is not None:
            on_pick(inst.instance_id)
        self.router.on_dispatch(inst.instance_id)
        try:
            # chaos seam: dispatch failure (instance picked but the
            # stream never opens — the pick-vs-death race, injectable)
            await chaos.ahit("request_plane.dispatch",
                             key=f"{self.endpoint.path}:{inst.instance_id}")
            async for item in self.runtime.request_client.stream(
                inst.address, self.endpoint.path, payload, ctx=ctx,
                token=token, instance_id=inst.instance_id,
            ):
                yield item
        finally:
            self.router.on_complete(inst.instance_id)

    async def round_robin(self, payload: Any, **kw) -> AsyncIterator[Any]:
        async for item in self.generate(payload, **kw):
            yield item

    async def direct(self, payload: Any, instance_id: int, **kw) -> AsyncIterator[Any]:
        async for item in self.generate(payload, instance_id=instance_id, **kw):
            yield item

    async def close(self) -> None:
        self._cancel.set()
        if self._watch_task is not None:
            self._watch_task.cancel()
            self._watch_task = None
