"""The port's copy of the distributed runtime (dynamo_tpu/runtime/), with
the same module names, `DYN_*` environment and wire formats, and none of
its third-party dependencies: the msgpack codec is the port's own
(codec.py) and pyzmq is needed only by the zmq event plane."""

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
from .push_router import PushRouter
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
    "Namespace",
    "PushRouter",
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
