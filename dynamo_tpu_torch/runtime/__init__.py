"""The port's copy of the distributed runtime (dynamo_tpu/runtime/), with
the same module names, `DYN_*` environment and wire formats, and none of
its third-party dependencies: the msgpack codec (codec.py), the
Prometheus renderer (metrics.py) and the system-status HTTP server
(system_status.py) are the port's own, and pyzmq is needed only by the
zmq event plane."""

from .cancellation import CancellationToken
from .component import Client, Component, Endpoint, Namespace, ServedEndpoint
from .config import RuntimeConfig, parse_truthy
from .discovery import (
    DiscoveryBackend,
    FileDiscovery,
    Instance,
    MemDiscovery,
    WatchEvent,
    make_discovery,
    new_instance_id,
)
from .distributed import DistributedRuntime
from .event_plane import EventPlane, InProcEventPlane, ZmqEventPlane
from .metrics import MetricsHierarchy
from .push_router import PushRouter, RouterMode
from .request_plane import (
    EngineError,
    RequestContext,
    RequestPlaneClient,
    RequestPlaneServer,
)

__all__ = [
    "CancellationToken",
    "Client",
    "Component",
    "DiscoveryBackend",
    "DistributedRuntime",
    "Endpoint",
    "EngineError",
    "EventPlane",
    "FileDiscovery",
    "InProcEventPlane",
    "Instance",
    "MemDiscovery",
    "MetricsHierarchy",
    "Namespace",
    "PushRouter",
    "RouterMode",
    "RequestContext",
    "RequestPlaneClient",
    "RequestPlaneServer",
    "RuntimeConfig",
    "ServedEndpoint",
    "WatchEvent",
    "ZmqEventPlane",
    "make_discovery",
    "new_instance_id",
    "parse_truthy",
]
