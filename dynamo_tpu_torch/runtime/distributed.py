"""DistributedRuntime: the per-process root object.

A copy of dynamo_tpu/runtime/distributed.py: it owns the discovery
backend (with its lease heartbeat), the lazily-started request-plane
server, the request-plane client pool, the event plane, the metrics
hierarchy (runtime/metrics.py), the canary health registry and the root
cancellation token.  Everything else (`Namespace` → `Component` →
`Endpoint`) hangs off it.  With a non-zero system_port (DYN_SYSTEM_PORT;
negative = ephemeral) `start()` serves /health /live /metrics and the
token-gated /debug routes (runtime/system_status.py) and sets
`system_address`, which every served instance advertises in its
discovery metadata as `system_addr`; the debug, forensics and KV
source registries feed /debug/state, /debug/requests and /debug/kv.
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
from .metrics import MetricsHierarchy
from .request_plane import RequestPlaneClient, RequestPlaneServer

logger = logging.getLogger(__name__)


class DistributedRuntime:
    def __init__(self, config: Optional[RuntimeConfig] = None,
                 discovery: Optional[DiscoveryBackend] = None,
                 cluster_id: str = "default"):
        self.config = config or RuntimeConfig.from_env()
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
        self.metrics = MetricsHierarchy(namespace=self.config.namespace)
        self.system_health = SystemHealth(self)
        self.request_server.on_activity = self.system_health.notify_activity
        self._system_server = None
        # the fleet introspection plane: workers register state-dump
        # callables here and /debug/state merges them; system_address is
        # what instances advertise in discovery so the fleet aggregator
        # finds this process's scrape surface
        self.debug_sources: dict = {}
        # /debug/requests (per-request forensics) and /debug/kv (KV
        # accounting) merge theirs, kept apart so the heavier payloads
        # never ride a plain /debug/state scrape
        self.forensics_sources: dict = {}
        self.kv_sources: dict = {}
        self.system_address: str = ""
        self._closed = False

    @classmethod
    def detached(cls, **overrides) -> "DistributedRuntime":
        """Construct from environment (`DYN_*`), the worker-process entry."""
        return cls(config=RuntimeConfig.from_env(**overrides))

    def namespace(self, name: Optional[str] = None) -> Namespace:
        return Namespace(self, name or self.config.namespace)

    def register_debug_source(self, name: str, fn) -> None:
        """Register a callable (sync or async, returning a JSON-able
        dict) merged into /debug/state under `name`.  Worker sources
        include their `instance_id` so the fleet aggregator can join a
        dump entry to the discovery instance it describes."""
        self.debug_sources[name] = fn

    def unregister_debug_source(self, name: str) -> None:
        self.debug_sources.pop(name, None)

    def register_forensics_source(self, name: str, fn) -> None:
        """Register a callable returning a dynamo.forensics.v1 dump dict,
        merged into /debug/requests under `name`."""
        self.forensics_sources[name] = fn

    def unregister_forensics_source(self, name: str) -> None:
        self.forensics_sources.pop(name, None)

    def register_kv_source(self, name: str, fn) -> None:
        """Register a callable returning a dynamo.kv_ledger.v1 dump dict,
        merged into /debug/kv under `name`."""
        self.kv_sources[name] = fn

    def unregister_kv_source(self, name: str) -> None:
        self.kv_sources.pop(name, None)

    async def start(self) -> "DistributedRuntime":
        await self.discovery.start()
        if self.config.system_port:
            from .system_status import SystemStatusServer

            # negative = ephemeral (DYN_SYSTEM_PORT=-1): multi-process
            # single-host fleets can't share a fixed port, and the fleet
            # aggregator finds the bound port via discovery metadata
            self._system_server = SystemStatusServer(
                self, max(0, self.config.system_port))
            await self._system_server.start()
            # advertised on the request-plane host (the bind is 0.0.0.0;
            # the reachable address is the one the request plane
            # advertises)
            self.system_address = (f"{self.config.tcp_host}:"
                                   f"{self._system_server.bound_port}")
        return self

    async def shutdown(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.root_token.kill()
        await self.system_health.close()
        if self._system_server is not None:
            await self._system_server.close()
        await self.request_client.close()
        await self.request_server.close()
        await self.event_plane.close()
        await self.discovery.close()
        logger.info("runtime %d shut down", self.worker_id)

    async def __aenter__(self) -> "DistributedRuntime":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.shutdown()
