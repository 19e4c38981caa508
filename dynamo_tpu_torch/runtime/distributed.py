"""DistributedRuntime: the per-process root object.

A copy of dynamo_tpu/runtime/distributed.py: it owns the discovery
backend (with its lease heartbeat), the lazily-started request-plane
server, the request-plane client pool, the event plane, the canary
health registry and the root cancellation token.  Everything else
(`Namespace` → `Component` → `Endpoint`) hangs off it.

Not ported yet (ROADMAP.md): the Prometheus metrics hierarchy and the
system-status server (/health /live /metrics /debug), which the JAX
module serves with prometheus_client and aiohttp; a non-zero
DYN_SYSTEM_PORT therefore raises instead of being ignored.  The debug,
forensics and KV-ledger source registries go with that server.
"""

from __future__ import annotations

import logging
from typing import Optional

from .cancellation import CancellationToken
from .component import Namespace
from .config import RuntimeConfig
from .discovery import DiscoveryBackend, make_discovery, new_instance_id
from .event_plane import EventPlane, make_event_plane
from .health_check import SystemHealth
from .request_plane import RequestPlaneClient, RequestPlaneServer

logger = logging.getLogger(__name__)


class DistributedRuntime:
    def __init__(self, config: Optional[RuntimeConfig] = None,
                 discovery: Optional[DiscoveryBackend] = None,
                 cluster_id: str = "default"):
        self.config = config or RuntimeConfig.from_env()
        if self.config.system_port:
            raise NotImplementedError(
                "DYN_SYSTEM_PORT / system_port: the system-status server "
                "(/health /live /metrics) is not ported to dynamo_tpu_torch "
                "yet (ROADMAP.md); leave it 0")
        self.cluster_id = cluster_id
        self.worker_id = new_instance_id()
        self.root_token = CancellationToken()
        self.discovery = discovery or make_discovery(
            self.config.discovery_backend,
            path=self.config.discovery_path,
            ttl_s=self.config.lease_ttl_s,
            cluster_id=cluster_id,
        )
        ep_kind = self.config.event_plane
        if ep_kind == "auto":
            # multi-process discovery backends need a cross-process bus
            ep_kind = ("zmq" if self.config.discovery_backend
                       in ("file", "etcd") else "inproc")
        self.event_plane: EventPlane = make_event_plane(
            ep_kind, self.discovery, cluster_id,
            host=self.config.zmq_host or self.config.tcp_host,
        )
        self.request_server = RequestPlaneServer(
            self.config.tcp_host, self.config.tcp_port,
            root_token=self.root_token,
        )
        self.request_client = RequestPlaneClient()
        self.system_health = SystemHealth(self)
        self.request_server.on_activity = self.system_health.notify_activity
        self._closed = False

    @classmethod
    def detached(cls, **overrides) -> "DistributedRuntime":
        """Construct from environment (`DYN_*`), the worker-process entry."""
        return cls(config=RuntimeConfig.from_env(**overrides))

    def namespace(self, name: Optional[str] = None) -> Namespace:
        return Namespace(self, name or self.config.namespace)

    async def start(self) -> "DistributedRuntime":
        await self.discovery.start()
        return self

    async def shutdown(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.root_token.kill()
        await self.system_health.close()
        await self.request_client.close()
        await self.request_server.close()
        await self.event_plane.close()
        await self.discovery.close()
        logger.info("runtime %d shut down", self.worker_id)

    async def __aenter__(self) -> "DistributedRuntime":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.shutdown()
